"""The model zoo's serving path: the port of ``repro.models``.

Parameters and caches are the reference's trees (nested dicts, layers
stacked on axis 0) of torch tensors; ``convert`` carries them across.
"""
from repro_torch.models.transformer import (forward_decode, forward_full,
                                            init_cache, init_params, lm_loss)
