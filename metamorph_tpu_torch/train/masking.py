"""Per-template supervised-target masking (tokenize + mask non-assistant
spans): a copy of `metamorph_tpu/train/masking.py` (that package imports JAX
on import). Ids and labels are the same, list for list, and so are the
reference's quirks: the truncation control flow and the warning that masks a
whole sample on a round-length mismatch.

Parity with `metamorph/train/train.py:250-659`:
  * `preprocess_multimodal` wraps "<image>" -> "<image_start><image><image_end>"
    when mm_use_im_start_end (`train.py:309-332`);
  * `preprocess_llama3` — round splitting on <|eot_id|>, instruction spans
    masked to IGNORE_INDEX, tokenization-mismatch detection masks the whole
    sample (`train.py:501-597`);
  * `preprocess_plain` (`train.py:601-636`) and the dispatcher (`train.py:638-659`).

The tokenizer is injected as a callable `tokenize(str) -> list[int]` that
prepends the bos token (HF LLaMA-3 behavior); the reference's round-length
arithmetic depends on that (each per-round re-tokenization's spurious bos
exactly compensates the round's trailing <|eot_id|> stripped by the split).
"""

from __future__ import annotations

import warnings
from typing import Callable, Dict, List, Optional

from metamorph_tpu_torch.constants import (DEFAULT_IM_END_TOKEN,
                                           DEFAULT_IM_START_TOKEN,
                                           DEFAULT_IMAGE_TOKEN, IGNORE_INDEX)
from metamorph_tpu_torch.multimodal import conversation as conversation_lib
from metamorph_tpu_torch.multimodal.mm_utils import tokenizer_image_token

Tokenize = Callable[[str], List[int]]


def preprocess_multimodal(sources, mm_use_im_start_end: bool):
    """In-place wrap of the <image> token (`train.py:309-332`)."""
    for source in sources:
        for sentence in source:
            replace_token = DEFAULT_IMAGE_TOKEN
            if mm_use_im_start_end:
                replace_token = (DEFAULT_IM_START_TOKEN + replace_token
                                 + DEFAULT_IM_END_TOKEN)
            sentence["value"] = sentence["value"].replace(
                DEFAULT_IMAGE_TOKEN, replace_token)
    return sources


def _apply_template(sources, conv):
    roles = {"human": conv.roles[0], "gpt": conv.roles[1]}
    conversations = []
    for source in sources:
        if roles[source[0]["from"]] != conv.roles[0]:
            source = source[1:]  # drop a leading non-human turn
        conv.messages = []
        for j, sentence in enumerate(source):
            role = roles[sentence["from"]]
            assert role == conv.roles[j % 2], "role order mismatch"
            conv.append_message(role, sentence["value"])
        conversations.append(conv.get_prompt())
    return conversations


def _tok(prompt: str, tokenize: Tokenize, has_image: bool,
         bos_token_id: Optional[int]) -> List[int]:
    if has_image:
        return tokenizer_image_token(prompt, tokenize, bos_token_id=bos_token_id)
    return tokenize(prompt)


def preprocess_llama3(
    sources,
    tokenize: Tokenize,
    has_image: bool = False,
    bos_token_id: int = 128000,
    model_max_length: int = 4096,
) -> Dict[str, List[List[int]]]:
    conv = conversation_lib.conv_llama_3.copy()
    conversations = _apply_template(sources, conv)

    input_ids = [_tok(p, tokenize, has_image, bos_token_id) for p in conversations]
    targets = [list(ids) for ids in input_ids]

    sep = conv.sep + conv.roles[1]
    for conversation, target in zip(conversations, targets):
        total_len = len(target)

        rounds = conversation.split(conv.sep)
        re_rounds = [conv.sep.join(rounds[:2])]
        for conv_idx in range(2, len(rounds), 2):
            re_rounds.append(conv.sep.join(rounds[conv_idx:conv_idx + 2]))

        cur_len = 1
        target[:cur_len] = [IGNORE_INDEX] * cur_len
        for i, rou in enumerate(re_rounds):
            if rou == "":
                break
            parts = rou.split(sep)
            if len(parts) != 2:
                break
            parts[0] += sep
            round_len = len(_tok(rou, tokenize, has_image, bos_token_id))
            instruction_len = len(_tok(parts[0], tokenize, has_image, bos_token_id)) - 1
            for t in range(cur_len, min(cur_len + instruction_len, total_len)):
                target[t] = IGNORE_INDEX
            cur_len += round_len
        for t in range(cur_len, total_len):
            target[t] = IGNORE_INDEX

        if cur_len < model_max_length and cur_len != total_len:
            target[:] = [IGNORE_INDEX] * total_len
            warnings.warn(
                f"tokenization mismatch: {cur_len} vs. {total_len}. (ignored)")

    return {"input_ids": input_ids, "labels": targets}


def _mask_rounds(conversations, targets, tokenize, has_image, bos_token_id,
                 model_max_length, sep2, inst_sep, inst_off, start_len):
    """Shared round-masking loop for the TWO/LLAMA_2 separator styles
    (`train.py:374-409` and `:456-494`)."""
    for conversation, target in zip(conversations, targets):
        total_len = len(target)
        rounds = conversation.split(sep2)
        cur_len = start_len
        target[:cur_len] = [IGNORE_INDEX] * cur_len
        for rou in rounds:
            if rou == "":
                break
            parts = rou.split(inst_sep)
            if len(parts) != 2:
                break
            parts[0] += inst_sep
            round_len = len(_tok(rou, tokenize, has_image, bos_token_id))
            instruction_len = len(
                _tok(parts[0], tokenize, has_image, bos_token_id)) - inst_off
            for t in range(cur_len, min(cur_len + instruction_len, total_len)):
                target[t] = IGNORE_INDEX
            cur_len += round_len
        for t in range(cur_len, total_len):
            target[t] = IGNORE_INDEX
        if cur_len < model_max_length and cur_len != total_len:
            target[:] = [IGNORE_INDEX] * total_len
            warnings.warn(
                f"tokenization mismatch: {cur_len} vs. {total_len}. (ignored)")


def preprocess_llama_2(
    sources,
    tokenize: Tokenize,
    has_image: bool = False,
    bos_token_id: int = 128000,
    model_max_length: int = 4096,
) -> Dict[str, List[List[int]]]:
    """LLaMA-2 [INST] template masking (`train.py:335-414`)."""
    conv = conversation_lib.conv_templates["llama_2"].copy()
    conversations = _apply_template(sources, conv)
    input_ids = [_tok(p, tokenize, has_image, bos_token_id) for p in conversations]
    targets = [list(ids) for ids in input_ids]
    _mask_rounds(conversations, targets, tokenize, has_image, bos_token_id,
                 model_max_length, sep2=conv.sep2, inst_sep="[/INST] ",
                 inst_off=2, start_len=1)
    return {"input_ids": input_ids, "labels": targets}


def preprocess_v1(
    sources,
    tokenize: Tokenize,
    has_image: bool = False,
    bos_token_id: int = 128000,
    model_max_length: int = 4096,
) -> Dict[str, List[List[int]]]:
    """Vicuna-v1 TWO-separator template masking (`train.py:417-499`)."""
    conv = conversation_lib.conv_templates["v1"].copy()
    conversations = _apply_template(sources, conv)
    input_ids = [_tok(p, tokenize, has_image, bos_token_id) for p in conversations]
    targets = [list(ids) for ids in input_ids]
    _mask_rounds(conversations, targets, tokenize, has_image, bos_token_id,
                 model_max_length, sep2=conv.sep2,
                 inst_sep=conv.sep + conv.roles[1] + ": ",
                 inst_off=2, start_len=1)
    return {"input_ids": input_ids, "labels": targets}


def preprocess_plain(
    sources,
    tokenize: Tokenize,
    bos_token_id: int = 128000,
) -> Dict[str, List[List[int]]]:
    """Plain 2-turn (caption pretrain): mask the first turn (`train.py:601-636`)."""
    conv = conversation_lib.conv_plain.copy()
    conversations = _apply_template(sources, conv)
    input_ids = [tokenizer_image_token(p, tokenize, bos_token_id=bos_token_id)
                 for p in conversations]
    targets = [list(ids) for ids in input_ids]
    for target, source in zip(targets, sources):
        tokenized_len = len(tokenizer_image_token(
            source[0]["value"], tokenize, bos_token_id=bos_token_id))
        target[:tokenized_len] = [IGNORE_INDEX] * tokenized_len
    return {"input_ids": input_ids, "labels": targets}


def preprocess(
    sources,
    tokenize: Tokenize,
    has_image: bool = False,
    conv_version: str = "llama3",
    bos_token_id: int = 128000,
    model_max_length: int = 4096,
) -> Dict[str, List[List[int]]]:
    """Dispatcher (`train.py:638-659`); llama3 is the production path."""
    if conv_version == "plain":
        return preprocess_plain(sources, tokenize, bos_token_id)
    if conv_version == "llama3":
        return preprocess_llama3(sources, tokenize, has_image, bos_token_id,
                                 model_max_length)
    if conv_version.startswith("v1"):
        return preprocess_v1(sources, tokenize, has_image, bos_token_id,
                             model_max_length)
    if conv_version == "llama_2":
        return preprocess_llama_2(sources, tokenize, has_image, bos_token_id,
                                  model_max_length)
    raise NotImplementedError(f"template {conv_version}")
