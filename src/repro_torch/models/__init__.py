from repro_torch.models.bridge import params_from_numpy
from repro_torch.models.transformer import (forward, hidden, init_params,
                                            logits_from_hidden, param_shapes)

__all__ = ["forward", "hidden", "init_params", "logits_from_hidden",
           "param_shapes", "params_from_numpy"]
