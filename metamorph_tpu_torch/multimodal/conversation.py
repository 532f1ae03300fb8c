"""Conversation prompt templating: a copy of
`metamorph_tpu/multimodal/conversation.py` (that package imports JAX on
import). The separator styles, the template registry and the prompts they
render are the same, character for character; the LLaMA-3 header format is
the default. Templates are plain data with a `get_prompt()`; PIL is needed
only by the serving-UI image helpers, which import it when called.
"""

from __future__ import annotations

import dataclasses
from enum import Enum, auto
from typing import List, Optional, Tuple


class SeparatorStyle(Enum):
    SINGLE = auto()
    TWO = auto()
    MPT = auto()
    PLAIN = auto()
    LLAMA_2 = auto()
    LLAMA_3 = auto()


@dataclasses.dataclass
class Conversation:
    system: str
    roles: Tuple[str, str]
    messages: List[List[Optional[str]]]
    offset: int
    sep_style: SeparatorStyle = SeparatorStyle.SINGLE
    sep: str = "###"
    sep2: Optional[str] = None
    version: str = "Unknown"

    def get_prompt(self) -> str:
        messages = self.messages
        if messages and isinstance(messages[0][1], tuple):
            # (msg, image, mode) tuples from demo flows: ensure "<image>\n" prefix
            messages = [list(m) for m in self.messages]
            role, payload = messages[0]
            msg = payload[0].replace("<image>", "").strip()
            messages[0] = [role, "<image>\n" + msg]

        style = self.sep_style
        if style == SeparatorStyle.SINGLE:
            ret = self.system + self.sep
            for role, message in messages:
                if message:
                    ret += role + ": " + _text(message) + self.sep
                else:
                    ret += role + ":"
            return ret
        if style == SeparatorStyle.TWO:
            seps = [self.sep, self.sep2]
            ret = self.system + seps[0]
            for i, (role, message) in enumerate(messages):
                if message:
                    ret += role + ": " + _text(message) + seps[i % 2]
                else:
                    ret += role + ":"
            return ret
        if style in (SeparatorStyle.MPT, SeparatorStyle.LLAMA_3):
            ret = self.system if style == SeparatorStyle.LLAMA_3 else self.system + self.sep
            if style == SeparatorStyle.MPT:
                for role, message in messages:
                    ret += role + (_text(message) + self.sep if message else "")
                return ret
            for role, message in messages:
                ret += role + (_text(message) + self.sep if message else "")
            return ret
        if style == SeparatorStyle.LLAMA_2:
            def wrap_sys(msg):
                return f"<<SYS>>\n{msg}\n<</SYS>>\n\n" if msg else msg

            def wrap_inst(msg):
                return f"[INST] {msg} [/INST]"

            ret = ""
            for i, (role, message) in enumerate(messages):
                if message:
                    msg = _text(message)
                    if i == 0:
                        msg = wrap_sys(self.system) + msg
                    if i % 2 == 0:
                        ret += self.sep + wrap_inst(msg)
                    else:
                        ret += " " + msg + " " + self.sep2
            return ret.lstrip(self.sep)
        if style == SeparatorStyle.PLAIN:
            ret = self.system + self.sep
            for role, message in messages:
                ret += role + (_text(message) + self.sep if message else "")
            return ret
        raise ValueError(f"Invalid style: {style}")

    def append_message(self, role: str, message: Optional[str]):
        self.messages.append([role, message])

    def process_image(self, image, image_process_mode: str,
                      return_pil: bool = False, image_format: str = "PNG",
                      max_len: int = 1344, min_len: int = 672):
        """Serving-UI image prep (`conversation.py:129-166`): Pad (expand to
        square on the (122,116,104) background) / Default / Crop (no-op) /
        Resize (336x336), then a max-edge cap, returned as a numpy array or a
        base64-encoded string. Accepts numpy HxWx3 or PIL."""
        import base64
        import io

        import numpy as np

        from metamorph_tpu_torch.multimodal.mm_utils import (
            _to_array, expand2square, resize_bilinear)

        arr = _to_array(image)
        if image_process_mode == "Pad":
            arr = expand2square(arr, (122, 116, 104))
        elif image_process_mode in ("Default", "Crop"):
            pass
        elif image_process_mode == "Resize":
            arr = resize_bilinear(arr, (336, 336)).astype(np.uint8)
        else:
            raise ValueError(f"Invalid image_process_mode: {image_process_mode}")
        h, w = arr.shape[:2]
        if max(h, w) > max_len:
            aspect = max(h, w) / min(h, w)
            short = int(min(max_len / aspect, min_len, min(h, w)))
            long_ = int(short * aspect)
            nh, nw = (long_, short) if h > w else (short, long_)
            arr = resize_bilinear(arr, (nh, nw)).astype(np.uint8)
        if return_pil:
            return arr
        from PIL import Image

        buf = io.BytesIO()
        Image.fromarray(arr.astype(np.uint8)).save(buf, format=image_format)
        return base64.b64encode(buf.getvalue()).decode()

    def get_images(self, return_pil: bool = False) -> List:
        """Images attached to user turns, processed (`conversation.py:169-176`)."""
        images = []
        for i, (role, msg) in enumerate(self.messages[self.offset:]):
            if i % 2 == 0 and isinstance(msg, tuple):
                _, image, mode = msg
                images.append(self.process_image(image, mode,
                                                 return_pil=return_pil))
        return images

    def to_gradio_chatbot(self) -> List:
        """[user, assistant] message pairs with inline base64 JPEG image tags
        (`conversation.py:179-194`)."""
        ret: List = []
        for i, (role, msg) in enumerate(self.messages[self.offset:]):
            if i % 2 == 0:
                if isinstance(msg, tuple):
                    text, image, _ = msg
                    b64 = self.process_image(image, "Default",
                                             return_pil=False,
                                             image_format="JPEG")
                    tag = (f'<img src="data:image/jpeg;base64,{b64}" '
                           f'alt="user upload image" />')
                    ret.append([tag + text.replace("<image>", "").strip(), None])
                else:
                    ret.append([msg, None])
            else:
                ret[-1][-1] = msg
        return ret

    def dict(self) -> dict:
        """Serializable state (`conversation.py:208-225`); image payloads are
        reduced to their text."""
        return {
            "system": self.system,
            "roles": self.roles,
            "messages": [[r, (m[0] if isinstance(m, tuple) else m)]
                         for r, m in self.messages],
            "offset": self.offset,
            "sep": self.sep,
            "sep2": self.sep2,
        }

    def copy(self) -> "Conversation":
        return Conversation(
            system=self.system, roles=self.roles,
            messages=[[r, m] for r, m in self.messages],
            offset=self.offset, sep_style=self.sep_style,
            sep=self.sep, sep2=self.sep2, version=self.version)


def _text(message):
    return message[0] if isinstance(message, tuple) else message


conv_vicuna_v0 = Conversation(
    system="A chat between a curious human and an artificial intelligence assistant. "
           "The assistant gives helpful, detailed, and polite answers to the human's questions.",
    roles=("Human", "Assistant"),
    messages=[],
    offset=2,
    sep_style=SeparatorStyle.SINGLE,
    sep="###",
    version="v0",
)

conv_chatml_direct = Conversation(
    system="",
    roles=("<|im_start|>user\n", "<|im_start|>assistant\n"),
    version="mpt",
    messages=[],
    offset=0,
    sep_style=SeparatorStyle.MPT,
    sep="<|im_end|>",
)

conv_llama_3 = Conversation(
    system="<|begin_of_text|>",
    roles=("<|start_header_id|>user<|end_header_id|>\n",
           "<|start_header_id|>assistant<|end_header_id|>\n"),
    version="llama3",
    messages=[],
    offset=0,
    sep_style=SeparatorStyle.LLAMA_3,
    sep="<|eot_id|>",
)

conv_plain = Conversation(
    system="",
    roles=("", ""),
    messages=[],
    offset=0,
    sep_style=SeparatorStyle.PLAIN,
    sep="\n",
    version="plain",
)

conv_vicuna_v1 = Conversation(
    system="A chat between a curious user and an artificial intelligence "
           "assistant. The assistant gives helpful, detailed, and polite "
           "answers to the user's questions.",
    roles=("USER", "ASSISTANT"),
    messages=[],
    offset=0,
    sep_style=SeparatorStyle.TWO,
    sep=" ",
    sep2="</s>",
    version="v1",
)

conv_llama_2 = Conversation(
    system="",
    roles=("USER", "ASSISTANT"),
    messages=[],
    offset=0,
    sep_style=SeparatorStyle.LLAMA_2,
    sep="<s>",
    sep2="</s>",
    version="llama_v2",
)

default_conversation = conv_llama_3

# Registry mirrors `conversation.py:283-290`, plus the v1/llama_2 templates the
# masking preprocessors (`train.py:335-499`) consume — the reference selects
# them via `model_args.version` (`train.py:1487-1490`) but ships a registry
# that would KeyError on the "vicuna_v1" fallback; we register them properly.
conv_templates = {
    "default": conv_vicuna_v0,
    "v0": conv_vicuna_v0,
    "v1": conv_vicuna_v1,
    "vicuna_v1": conv_vicuna_v1,
    "llama_2": conv_llama_2,
    "llama3": conv_llama_3,
    "chatml_direct": conv_chatml_direct,
    "mistral_direct": conv_chatml_direct,
    "plain": conv_plain,
}
