"""Device ops of the band engine: plain PyTorch ops and the CUDA band Pearson."""
