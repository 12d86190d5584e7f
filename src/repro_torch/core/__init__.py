"""Single-session PBS protocol in numpy: the port's own oracle.

Hash families, GF(2^m) arithmetic, BCH codes, the ToW estimator, the Markov
parameter optimizer and the ``reconcile`` state machine every batched path
is held against.
"""
