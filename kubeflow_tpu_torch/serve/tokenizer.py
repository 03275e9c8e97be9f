"""WordPiece tokenizer from a ``vocab.txt``, pure offline Python: the
port's copy of ``kubeflow_tpu/serve/tokenizer.py``.

The real tokenizer of the BERT runtime: an HF-format model directory
ships ``vocab.txt``, and serving must index the checkpoint's embedding
table with the ids the model was trained with. It follows the published
WordPiece algorithm (greedy longest-match-first with ``##``
continuations) plus BERT's basic tokenization (lower-casing, accent
stripping, punctuation splitting, CJK isolation).
"""

from __future__ import annotations

import unicodedata
from pathlib import Path
from typing import Iterable


def load_vocab(path: str | Path) -> dict[str, int]:
    """vocab.txt: one token per line; id = line number."""
    vocab: dict[str, int] = {}
    with open(path, encoding="utf-8") as f:
        for i, line in enumerate(f):
            tok = line.rstrip("\n")
            if tok:
                vocab.setdefault(tok, i)
    return vocab


def _is_punctuation(ch: str) -> bool:
    cp = ord(ch)
    # ASCII ranges BERT treats as punctuation even when unicodedata doesn't
    if (33 <= cp <= 47) or (58 <= cp <= 64) or (91 <= cp <= 96) or (123 <= cp <= 126):
        return True
    return unicodedata.category(ch).startswith("P")


def _is_cjk(cp: int) -> bool:
    return (
        0x4E00 <= cp <= 0x9FFF
        or 0x3400 <= cp <= 0x4DBF
        or 0x20000 <= cp <= 0x2A6DF
        or 0x2A700 <= cp <= 0x2B73F
        or 0x2B740 <= cp <= 0x2B81F
        or 0x2B820 <= cp <= 0x2CEAF
        or 0xF900 <= cp <= 0xFAFF
        or 0x2F800 <= cp <= 0x2FA1F
    )


def _is_control(ch: str) -> bool:
    if ch in ("\t", "\n", "\r"):
        return False
    return unicodedata.category(ch) in ("Cc", "Cf")


class WordPieceTokenizer:
    """BERT-style tokenizer: basic tokenization + greedy WordPiece.

    ``do_lower_case`` matches bert-base-uncased semantics (lowercase +
    strip accents). Special tokens are resolved from the vocab, so a
    checkpoint with non-standard ids still round-trips correctly.
    """

    def __init__(
        self,
        vocab: dict[str, int] | str | Path,
        *,
        do_lower_case: bool = True,
        unk_token: str = "[UNK]",
        max_chars_per_word: int = 100,
    ):
        if not isinstance(vocab, dict):
            vocab = load_vocab(vocab)
        self.vocab = vocab
        self.ids_to_tokens = {i: t for t, i in vocab.items()}
        self.do_lower_case = do_lower_case
        self.unk_token = unk_token
        self.max_chars_per_word = max_chars_per_word
        for required in (unk_token, "[CLS]", "[SEP]"):
            if required not in vocab:
                raise ValueError(f"vocab missing required token {required!r}")
        self.unk_id = vocab[unk_token]
        self.cls_id = vocab["[CLS]"]
        self.sep_id = vocab["[SEP]"]
        self.pad_id = vocab.get("[PAD]", 0)
        self.mask_id = vocab.get("[MASK]")
        # never lowercase/split the special markers themselves
        self._specials = {
            t for t in ("[UNK]", "[CLS]", "[SEP]", "[PAD]", "[MASK]")
            if t in vocab
        }

    # -- basic tokenization ------------------------------------------------ #

    def _clean(self, text: str) -> str:
        out = []
        for ch in text:
            cp = ord(ch)
            if cp == 0 or cp == 0xFFFD or _is_control(ch):
                continue
            if _is_cjk(cp):
                out.append(f" {ch} ")
            elif ch.isspace():
                out.append(" ")
            else:
                out.append(ch)
        return "".join(out)

    def _split_word(self, word: str) -> list[str]:
        """Lowercase/strip accents, then split on punctuation."""
        if word in self._specials:
            return [word]
        if self.do_lower_case:
            word = word.lower()
            word = unicodedata.normalize("NFD", word)
            word = "".join(
                ch for ch in word if unicodedata.category(ch) != "Mn"
            )
        pieces: list[str] = []
        current: list[str] = []
        for ch in word:
            if _is_punctuation(ch):
                if current:
                    pieces.append("".join(current))
                    current = []
                pieces.append(ch)
            else:
                current.append(ch)
        if current:
            pieces.append("".join(current))
        return pieces

    def basic_tokenize(self, text: str) -> list[str]:
        tokens: list[str] = []
        for word in self._clean(text).split():
            tokens.extend(self._split_word(word))
        return tokens

    # -- wordpiece --------------------------------------------------------- #

    def wordpiece(self, token: str) -> list[str]:
        """Greedy longest-match-first; whole word → [UNK] if any char fails."""
        if token in self._specials:
            return [token]
        if len(token) > self.max_chars_per_word:
            return [self.unk_token]
        pieces: list[str] = []
        start = 0
        while start < len(token):
            end = len(token)
            cur = None
            while start < end:
                sub = token[start:end]
                if start > 0:
                    sub = "##" + sub
                if sub in self.vocab:
                    cur = sub
                    break
                end -= 1
            if cur is None:
                return [self.unk_token]
            pieces.append(cur)
            start = end
        return pieces

    def tokenize(self, text: str) -> list[str]:
        out: list[str] = []
        for tok in self.basic_tokenize(text):
            out.extend(self.wordpiece(tok))
        return out

    # -- encode / decode --------------------------------------------------- #

    def encode(
        self,
        text: str,
        text_pair: str | None = None,
        *,
        add_special_tokens: bool = True,
    ) -> list[int]:
        ids = [self.vocab.get(t, self.unk_id) for t in self.tokenize(text)]
        if not add_special_tokens:
            return ids
        full = [self.cls_id, *ids, self.sep_id]
        if text_pair is not None:
            pair = [self.vocab.get(t, self.unk_id) for t in self.tokenize(text_pair)]
            full += [*pair, self.sep_id]
        return full

    def convert_ids_to_tokens(self, ids: Iterable[int]) -> list[str]:
        return [self.ids_to_tokens.get(int(i), self.unk_token) for i in ids]

    def decode(self, ids: Iterable[int], *, skip_special_tokens: bool = True) -> str:
        toks = self.convert_ids_to_tokens(ids)
        if skip_special_tokens:
            toks = [t for t in toks if t not in self._specials]
        words: list[str] = []
        for t in toks:
            if t.startswith("##") and words:
                words[-1] += t[2:]
            else:
                words.append(t)
        return " ".join(words)

    @property
    def vocab_size(self) -> int:
        return len(self.vocab)
