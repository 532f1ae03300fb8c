"""Special token ids and geometry constants, copied from
`metamorph_tpu/constants.py` (that package imports JAX on import). The values
must stay identical: tokenized data and checkpoints are shared between the
two packages."""

IGNORE_INDEX = -100
IMAGE_TOKEN_INDEX = -200
DEFAULT_IMAGE_TOKEN = "<image>"
DEFAULT_IMAGE_PATCH_TOKEN = "<im_patch>"
DEFAULT_IM_START_TOKEN = "<image_start>"
DEFAULT_IM_END_TOKEN = "<image_end>"
IMAGE_PLACEHOLDER = "<image-placeholder>"

# LLaMA-3 vocabulary is 128256 tokens; the two added vision tokens take the
# next slots. The decode state machine keys on these ids.
LLAMA3_BASE_VOCAB = 128256
IM_START_TOKEN_ID = 128256  # "<image_start>"
IM_END_TOKEN_ID = 128257    # "<image_end>"

# LLaMA-3 eos candidates that stop generation.
LLAMA3_EOS_IDS = (128001, 128009)

# SigLIP-SO400M-patch14-384 geometry.
SIGLIP_HIDDEN = 1152
SIGLIP_PATCHES = 729  # 27 x 27
