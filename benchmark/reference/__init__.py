"""The plain reference that decides ``correct``.

Plain numpy, scipy and torch operations written from the definitions of
the clustering and the exact scan, independent of the program: nothing
here imports the program, reads its files or takes its outputs except to
judge them.  Every value that the program derives (hash constants, the
one-permutation constants, signatures, band keys, the store's row order)
is worked out again here from the seed and the sessions.
"""
