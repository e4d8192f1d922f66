"""Postnet-side landmark projection (port of `genefaceplusplus_tpu/models/postnet/`):
the LLE projection. The postnet CNN itself is not ported yet."""
