"""Kernels: the Hopper ``sig_trunc`` and ``sig_words`` kernels, their plain
versions and the signature / projection dispatch."""
