"""The JAX package's example scripts over the port (counterparts of
ceres_tpu/examples/): each keeps its twin's flags, defaults and printed
lines, takes --device (default cuda; --device cpu runs the plain PyTorch
versions) and has main(argv=None), which returns the summary, or the list
of summaries where the script solves more than once.

    python -m ceres_tpu_torch.examples.helloworld --device cpu

The nist and denoising examples wait for their models.
"""
