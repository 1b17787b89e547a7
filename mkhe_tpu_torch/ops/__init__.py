"""Ring arithmetic substrate: modmath, ring, NTT kernels, basis, sampling."""
