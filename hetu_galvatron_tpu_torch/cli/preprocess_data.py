"""The byte tokenizer of corpus preparation.

Port of ``ByteTokenizer`` and ``make_tokenizer`` (:52) of
``hetu_galvatron_tpu/cli/preprocess_data.py``, which ``cli/generate.py``
and ``cli/serve.py`` use. Only the byte tokenizer runs here: any other
tokenizer name is a Hugging Face tokenizer, which needs ``transformers``
and a download, and raises. The corpus launcher itself is not ported.
"""

from __future__ import annotations

from typing import List, Optional


class ByteTokenizer:
    """UTF-8 bytes as ids, eod = 256."""

    vocab_size = 257
    eod_id = 256
    mask_id = None

    def encode(self, text: str) -> List[int]:
        return list(text.encode("utf-8"))

    def decode(self, ids: List[int]) -> str:
        return bytes(i for i in ids if i < 256).decode("utf-8",
                                                       errors="replace")


def make_tokenizer(name: Optional[str]) -> ByteTokenizer:
    """The byte tokenizer for no name or ``byte``; any other name is a
    Hugging Face tokenizer, which this package does not load."""
    if not name or name == "byte":
        return ByteTokenizer()
    raise NotImplementedError(
        f"tokenizer={name!r}: Hugging Face tokenizers need `transformers` "
        "and a download, which hetu_galvatron_tpu_torch does not use; only "
        "tokenizer=byte runs")
