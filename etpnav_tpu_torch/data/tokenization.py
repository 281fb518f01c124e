"""Tokenizer construction (counterpart of
`etpnav_tpu/data/tokenization.py`).

Capability target: vlnbert_init.py:4-11 get_tokenizer — bert-base-uncased
for R2R, xlm-roberta-base for RxR, loaded from local `bert_config/` dirs
when present (offline) or from the HF hub name otherwise. `transformers`
is imported inside the functions that build a tokenizer.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np


def _default_config_dirs():
    """cwd `bert_config/` (the reference's repo-root layout) first, then
    the vendored `configs/bert_config/` of this repository."""
    repo = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    return ["bert_config", os.path.join(repo, "configs", "bert_config")]


def _xlmr_from_artifact(path: str):
    """XLM-R tokenizer from an explicit artifact: a `tokenizer.json`
    (fast path, no sentencepiece package needed) or a
    `sentencepiece.bpe.model` (slow path, requires sentencepiece). A
    directory is searched for either, fast first."""
    if os.path.isdir(path):
        for f in ("tokenizer.json", "sentencepiece.bpe.model"):
            cand = os.path.join(path, f)
            if os.path.exists(cand):
                path = cand
                break
        else:
            raise RuntimeError(
                f"ETPNAV_XLMR_TOKENIZER dir {path!r} holds neither "
                "tokenizer.json nor sentencepiece.bpe.model")
    if path.endswith(".json"):
        from transformers import XLMRobertaTokenizerFast
        return XLMRobertaTokenizerFast(vocab_file=None, tokenizer_file=path)
    try:
        import sentencepiece  # noqa: F401
    except ImportError as e:
        raise RuntimeError(
            f"Loading {path!r} needs the `sentencepiece` package, which "
            "is not installed. Convert the model once to tokenizer.json "
            "(XLMRobertaTokenizerFast.save_pretrained on any machine with "
            "sentencepiece) and point ETPNAV_XLMR_TOKENIZER at that "
            "instead.") from e
    from transformers import XLMRobertaTokenizer
    return XLMRobertaTokenizer(vocab_file=path)


def get_tokenizer(task_type: str = "r2r",
                  bert_config_dir: Optional[str] = "bert_config",
                  tokenizer_path: Optional[str] = None):
    """tokenizer_path / $ETPNAV_XLMR_TOKENIZER: explicit artifact override
    so an operator with the XLM-R sentencepiece/tokenizer.json file can
    run RxR fully offline (the repository vendors only the config.json of
    xlm-roberta-base; the reference takes the tokenizer from the hub at
    vlnbert_init.py:8-11)."""
    from transformers import AutoTokenizer
    name = ("xlm-roberta-base" if task_type == "rxr"
            else "bert-base-uncased")
    if name == "xlm-roberta-base":
        explicit = tokenizer_path or os.environ.get("ETPNAV_XLMR_TOKENIZER")
        if explicit:
            return _xlmr_from_artifact(explicit)
    dirs = ([bert_config_dir] if bert_config_dir not in (None, "bert_config")
            else _default_config_dirs())
    for d in dirs:
        local = os.path.join(d, name)
        # A config dir only makes a usable tokenizer if the vocab files
        # are present; config.json alone falls through to the hub name.
        if os.path.isdir(local) and any(
                os.path.exists(os.path.join(local, f))
                for f in ("vocab.txt", "sentencepiece.bpe.model",
                          "tokenizer.json")):
            return AutoTokenizer.from_pretrained(local)
    try:
        return AutoTokenizer.from_pretrained(name)
    except OSError as e:
        raise RuntimeError(
            f"No vendored tokenizer files for '{name}' under any of {dirs} "
            "and the HF hub is unreachable. Place vocab.txt (bert) or "
            "sentencepiece.bpe.model / tokenizer.json (xlm-roberta) in "
            f"<bert_config_dir>/{name}/ to run offline.") from e


def encode_instruction(tokenizer, text: str, max_len: int) -> np.ndarray:
    """Text -> fixed-length id array with the tokenizer's pad id."""
    ids = tokenizer(text, truncation=True, max_length=max_len)["input_ids"]
    out = np.full(max_len, tokenizer.pad_token_id, np.int64)
    out[:len(ids)] = ids
    return out
