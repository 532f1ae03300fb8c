"""metamorph_tpu_torch: the PyTorch + CUDA counterpart of `metamorph_tpu`,
for one NVIDIA H100 (sm_90a).

This package imports torch and never JAX. Its module names mirror the JAX
package's, so `metamorph_tpu_torch/models/llama.py` is the counterpart of
`metamorph_tpu/models/llama.py`. Ported so far: the serving path
(`inference/serve.py`'s `ServeEngine`) and the training path
(`train/trainer.py`'s `train()`, `train/train_step.py`), on four
hand-written CUDA C++ kernels under `csrc/`: the flash-attention forward
and its dq and dk/dv backward (`ops/flash_attention.py`), and decode
attention (`ops/decode_attention.py`).

    from metamorph_tpu_torch.config import MetaMorphConfig
    from metamorph_tpu_torch.convert import init_params, from_jax_params
    from metamorph_tpu_torch.inference.serve import Request, ServeEngine
    from metamorph_tpu_torch.train.trainer import TrainerArgs, train
"""

__version__ = "0.1.0"
