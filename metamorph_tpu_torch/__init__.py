"""metamorph_tpu_torch: the PyTorch + CUDA counterpart of `metamorph_tpu`,
for one NVIDIA H100 (sm_90a).

This package imports torch and never JAX. Its module names mirror the JAX
package's, so `metamorph_tpu_torch/models/llama.py` is the counterpart of
`metamorph_tpu/models/llama.py`. Ported so far: the serving path
(`inference/serve.py`'s `ServeEngine`, with its int8 KV cache,
prompt-lookup and draft-model speculation, chunked fill and a shared
prefix; int8 weights from `ops/quant.py`; the decode entry points, the
demo, the serve CLI and the HTTP server), the eval path
(`eval/perplexity.py`, `eval/runner.py`), the training path
(`train/trainer.py`'s `train()`, `train/train_step.py`) and the recipe's
data path (`train/data.py`'s dataset and iterator over a conversation
JSONL, with the templates, masking, anyres and the native packer, and the
`train/main.py` CLI) and the weights slice (`utils/safetensors_io.py`,
`models/hf_import.py`'s HF-layout import and export, `inference/loader.py`,
`models/lora.py` with LoRA on every LLaMA path, the adapter, LoRA and
HF-export saves of `train/checkpoint.py`, and `consolidate.py`) and the
visualizer's render path (`visualizer/`: schedulers, adapter, SD-1.5 UNet
and VAE, `render`, diffusers-format import; its checkpoints through
`inference/loader.py`, `--visualizer` in the demo) and its training, and
multi-GPU training (`parallel/`: the (data, fsdp, tensor) mesh on
torch.distributed, FSDP2, tensor parallelism, ring attention with
sequence parallelism; `make_sharded_train_step`), on six
hand-written CUDA C++ kernels under `csrc/`: the flash-attention forward
and its dq and dk/dv backward (`ops/flash_attention.py`), decode attention
over a bf16 or int8 cache, chunk attention (`ops/decode_attention.py`),
and the weight-only int8 product (`ops/quant.py`).
Entry points run on the card unless the caller passes `device="cpu"`.

    from metamorph_tpu_torch.config import MetaMorphConfig
    from metamorph_tpu_torch.convert import init_params, from_jax_params
    from metamorph_tpu_torch.inference.serve import Request, ServeEngine
    from metamorph_tpu_torch.train.trainer import TrainerArgs, train
    from metamorph_tpu_torch.inference.loader import (load_pretrained_model,
                                                      load_lora_model)
    from metamorph_tpu_torch.models.lora import add_lora, merge_lora
    from metamorph_tpu_torch.train.checkpoint import export_hf, save_lora
    from metamorph_tpu_torch.inference.loader import load_visualization
    from metamorph_tpu_torch.visualizer.pipeline import render
    python -m metamorph_tpu_torch.train.main --config ... --data-path ...
    torchrun --nproc_per_node 8 -m metamorph_tpu_torch.train.main --multihost ...
    python -m metamorph_tpu_torch.consolidate --src OUT --dst EXPORT
"""

__version__ = "0.1.0"
