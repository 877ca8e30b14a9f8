"""The PSF convolution ('same' convolution of stamps with a carried
spectrum, its adjoint, the gradient's Ht(HX - Y) and the pair): CUDA
kernel, plain version, wrappers."""
