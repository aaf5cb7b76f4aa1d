"""Kernels: the Hopper ``sig_trunc`` kernel, its plain version and the
signature dispatch."""
