"""The plain reference that decides `correct`.

Plain NumPy and plain PyTorch, on whatever device the tensors it is handed
live on. It imports neither JAX, nor the JAX package, nor anything of
mkhe_tpu_torch: the prime search, the rescale rule and the CNN's forward
pass are frozen copies kept here, and every table (roots of unity, CRT
constants, slot order) is worked out again from the configuration's
numbers. It reads the program's outputs only to judge them.
"""
