"""repro_torch: the PyTorch/CUDA port of the MP-BCFW structural-SVM trainer.

A second package beside the JAX reference ``repro``: the same algorithm
(paper Alg. 3) in PyTorch, with the TPU's Pallas kernels replaced by
hand-written CUDA kernels for Hopper (``kernels/csrc``).  Entry points run
on CUDA unless the caller passes ``device="cpu"``, where every kernel
runs as its plain PyTorch version.

    from repro_torch.api import RunConfig, Solver
    from repro_torch.core.oracles import chain
    from repro_torch.data.synthetic import ocr_like

    X, Y, M = ocr_like(n=6877, f=128, num_labels=26, mean_len=8, max_len=14)
    result = Solver(chain.make_problem(X, Y, M, 26),
                    RunConfig(lam=1 / 6877, max_iters=3)).run()
"""
