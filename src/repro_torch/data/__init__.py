"""Deterministic, host-sharded, seekable token pipeline (port of
``repro.data``)."""
from repro_torch.data.pipeline import (DataConfig, ShardedTokenPipeline,
                                       write_synthetic_corpus)
