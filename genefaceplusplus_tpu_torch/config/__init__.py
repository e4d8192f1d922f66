from genefaceplusplus_tpu_torch.config.config import (  # noqa: F401
    Config, apply_overrides, load_config, save_config, set_hparams)
