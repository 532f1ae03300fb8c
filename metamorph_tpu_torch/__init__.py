"""metamorph_tpu_torch: the PyTorch + CUDA counterpart of `metamorph_tpu`,
for one NVIDIA H100 (sm_90a).

This package imports torch and never JAX. Its module names mirror the JAX
package's, so `metamorph_tpu_torch/models/llama.py` is the counterpart of
`metamorph_tpu/models/llama.py`. Ported so far: the serving path
(`inference/serve.py`'s `ServeEngine`, with its int8 KV cache,
prompt-lookup speculation and chunked fill), the training path
(`train/trainer.py`'s `train()`, `train/train_step.py`) and the recipe's
data path (`train/data.py`'s dataset and iterator over a conversation
JSONL, with the templates, masking, anyres and the native packer, and the
`train/main.py` CLI), on five
hand-written CUDA C++ kernels under `csrc/`: the flash-attention forward
and its dq and dk/dv backward (`ops/flash_attention.py`), decode attention
over a bf16 or int8 cache, and chunk attention (`ops/decode_attention.py`).
Entry points run on the card unless the caller passes `device="cpu"`.

    from metamorph_tpu_torch.config import MetaMorphConfig
    from metamorph_tpu_torch.convert import init_params, from_jax_params
    from metamorph_tpu_torch.inference.serve import Request, ServeEngine
    from metamorph_tpu_torch.train.trainer import TrainerArgs, train
    python -m metamorph_tpu_torch.train.main --config ... --data-path ...
"""

__version__ = "0.1.0"
