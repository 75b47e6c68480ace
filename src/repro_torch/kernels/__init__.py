"""Hand-written CUDA kernels of the port, each beside its plain PyTorch
twin (the port of the reference kernel's ``ref.py`` oracle)."""
