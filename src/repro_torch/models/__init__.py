"""repro_torch.models — the decoder LM stack (attention, the Mamba-2 SSM
mixer, MoE with the grouped-GEMM kernel K9; the training loss and the
serving path) and its parameter accounting."""
from .model import (ModelConfig, ParamTree, decode_step, forward,
                    init_cache, init_params, logits_from_hidden, loss_fn,
                    prefill)
from .accounting import (attn_extra_flops, count_params, decode_model_flops,
                         train_model_flops)

__all__ = ["ModelConfig", "ParamTree", "decode_step", "forward",
           "init_cache", "init_params", "loss_fn", "logits_from_hidden",
           "prefill",
           "count_params", "train_model_flops", "attn_extra_flops",
           "decode_model_flops"]
