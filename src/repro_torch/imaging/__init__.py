"""Imaging operators and solvers: starlet, PSF, Condat, deconvolution."""
