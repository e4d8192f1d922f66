"""Postnet-side landmark models (port of `genefaceplusplus_tpu/models/postnet/`):
the LLE projection and the pitch-conditioned CNN refiner."""
