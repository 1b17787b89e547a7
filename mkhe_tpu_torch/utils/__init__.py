"""Host-side helpers of the port (port of mkhe_tpu/utils): the exact CRT
of the plaintext boundary (crt), the HE-Standard security table
(security), npz save and load of keys and ciphertexts (serialize) and the
u64 reference-oracle gate (oracle)."""
