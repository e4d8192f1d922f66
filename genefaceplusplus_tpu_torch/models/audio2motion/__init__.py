"""Audio -> motion: the pitch-conditioned flow-prior VAE (port of
`genefaceplusplus_tpu/models/audio2motion/`)."""
