"""Ring arithmetic substrate: modmath, ring, NTT kernels, basis, sampling
and the threefry bits it draws from."""
