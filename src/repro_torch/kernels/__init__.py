"""Kernels: the hand-written Hopper kernels (``sig_trunc``, ``sig_words``,
``sig_gram`` and the §4.2 ``sig_sweep``), their plain versions and the
signature / projection / Gram dispatch."""
