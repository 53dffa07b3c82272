"""The port's measurement labs: the Hopper counterparts of the JAX
package's bench/megakernel_lab4.py and bench/megakernel_lab6.py, which
drive the lab kernels K1r, L5 and L6 (raytpu_torch/kernels/labs.py) and
time them with the estimators of timing.py."""
