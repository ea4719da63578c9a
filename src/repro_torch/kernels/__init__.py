"""Hand-written CUDA kernels of the port, their wrappers, plain torch
versions (`ref`), the nvcc loader (`build`) and the engine adapters
(`ops`)."""
