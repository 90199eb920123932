"""Plain NumPy references of the benchmark's cells.

``ssvm.py`` holds MP-BCFW (paper Alg. 3) and BCFW-avg (Lacoste-Julien et
al.), written from the papers over an oracle object; ``chain.py`` (the
loss-augmented Viterbi oracle) and ``graph.py`` (red-black ICM) are the
oracles, found by a configuration's ``kind``.  ``precision.py`` holds the
products in float32 and, for the control, in TF32.  Nothing here imports
``torch``, ``jax`` or either package of the repository.
"""
