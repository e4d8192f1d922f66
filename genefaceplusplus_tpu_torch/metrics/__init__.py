from genefaceplusplus_tpu_torch.metrics.sync_scorer import (  # noqa: F401
    SyncScorer, sync_confidence, train_sync_scorer,
)
