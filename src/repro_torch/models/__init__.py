from repro_torch.models.bridge import params_from_numpy
from repro_torch.models.cache import init_cache
from repro_torch.models.transformer import (Model, decode_step, forward,
                                            hidden, init_params,
                                            logits_from_hidden, param_shapes,
                                            prefill)

__all__ = ["Model", "decode_step", "forward", "hidden", "init_cache",
           "init_params", "logits_from_hidden", "param_shapes",
           "params_from_numpy", "prefill"]
