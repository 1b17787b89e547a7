"""Walkthroughs of the port's public surface, the counterparts of the
repo's examples/*.py: python -m mkhe_tpu_torch.examples.two_party_ckks
(or .two_party_bfv); each main(device=None) runs on the card unless the
caller names another device."""
