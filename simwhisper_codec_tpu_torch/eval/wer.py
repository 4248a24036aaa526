"""WER: text normalization, DP edit distance, CTC ASR transcription.

Counterpart of ``simwhisper_codec_tpu/eval/wer.py`` (reference
``tools/wer/calculate_wer.py``: HuBERT-large CTC greedy decoding :269-374,
unicode / tag normalization, the DP edit-distance ``Calculator`` :97-227).
The text pipeline is a copy; the HuBERT-large tower runs on
``models/ssl.py`` with its CTC head, and its weights are read from a
Hugging Face model directory by ``utils/hf_dir.py``.  As the JAX
``CTCTranscriber`` jits ``ctc_logits`` once per padded length,
``CTCTranscriber.program`` runs it as a ``utils/aot.py`` program: a CUDA
graph per length bucket on the card.
"""

from __future__ import annotations

import unicodedata
from dataclasses import dataclass
from typing import Dict, List

import numpy as np
import torch
from torch.nn import functional as F

from simwhisper_codec_tpu_torch.models.codec import f32_precision, resolve_device
from simwhisper_codec_tpu_torch.models.ssl import hubert_large_ft_config, power_of_two_bucket, ssl_forward, tree_map
from simwhisper_codec_tpu_torch.utils import aot
from simwhisper_codec_tpu_torch.utils.hf_dir import have_hf_ctc_dir, read_hf_ctc_dir

# Exact behavioral parity with the reference text pipeline
# (tools/wer/calculate_wer.py:22-96): the published WER numbers were produced
# by these precise tokenization quirks, so the rebuild reproduces them
# faithfully (verified by the fuzz A/B in tests/test_wer_parity.py):
#   - the punctuation list is skipped only when a punct char *starts* a token;
#     a trailing "world!" keeps its '!' attached,
#   - category-Lo chars (CJK etc.) are emitted one char per token,
#   - a '<' opens a tag token grouped until '>' (inclusive); tags are later
#     removed by ``stripoff_tags`` inside ``normalize``,
#   - any char with ord >= 128 breaks a latin run.
_PUNCTS = frozenset("!,?、。！，；？：「」︰『』《》")
_SPACES = frozenset(" \t\r\n")


def characterize(text: str) -> List[str]:
    """Tokenize raw text (reference ``characterize``, calculate_wer.py:30-58)."""
    tokens: List[str] = []
    i, n = 0, len(text)
    while i < n:
        ch = text[i]
        if ch in _PUNCTS:
            i += 1
            continue
        cat = unicodedata.category(ch)
        if cat in ("Zs", "Cn") or ch in _SPACES:
            i += 1
            continue
        if cat == "Lo":
            tokens.append(ch)
            i += 1
            continue
        sep = ">" if ch == "<" else " "
        j = i + 1
        while j < n:
            c = text[j]
            if ord(c) >= 128 or c in _SPACES or c == sep:
                break
            j += 1
        if j < n and text[j] == ">":
            j += 1
        tokens.append(text[i:j])
        i = j
    return tokens


def stripoff_tags(token: str) -> str:
    """Drop ``<...>`` spans, unclosed tails included (calculate_wer.py:61-75)."""
    out: List[str] = []
    i, n = 0, len(token)
    while i < n:
        if token[i] == "<":
            while i < n and token[i] != ">":
                i += 1
            i += 1
        else:
            out.append(token[i])
            i += 1
    return "".join(out)


def normalize(tokens: List[str], ignore_words=(), case_sensitive: bool = False,
              split: Dict[str, List[str]] = None, remove_tag: bool = True) -> List[str]:
    """Uppercase -> drop ignores -> strip tags -> expand splits
    (reference ``normalize``, calculate_wer.py:78-96)."""
    out: List[str] = []
    for tok in tokens:
        if not case_sensitive:
            tok = tok.upper()
        if tok in ignore_words:
            continue
        if remove_tag:
            tok = stripoff_tags(tok)
        if not tok:
            continue
        if split and tok in split:
            out.extend(split[tok])
        else:
            out.append(tok)
    return out


def normalize_text(text: str) -> List[str]:
    """The full reference pipeline: ``normalize(characterize(text), [], False)``."""
    return normalize(characterize(text))


@dataclass
class EditStats:
    cor: int = 0
    sub: int = 0
    ins: int = 0
    dele: int = 0

    @property
    def errors(self) -> int:
        return self.sub + self.ins + self.dele

    @property
    def ref_words(self) -> int:
        return self.cor + self.sub + self.dele

    @property
    def wer(self) -> float:
        return self.errors / self.ref_words if self.ref_words else 0.0


def edit_distance(ref: List[str], hyp: List[str]) -> EditStats:
    """Levenshtein alignment with sub/ins/del attribution (Calculator parity)."""
    n, m = len(ref), len(hyp)
    # dp[i][j] = (cost, cor, sub, ins, del)
    INF = 10**9
    cost = np.zeros((n + 1, m + 1), np.int64)
    op = np.zeros((n + 1, m + 1), np.int8)  # 0 diag-cor, 1 diag-sub, 2 up-del, 3 left-ins
    for i in range(1, n + 1):
        cost[i][0] = i
        op[i][0] = 2
    for j in range(1, m + 1):
        cost[0][j] = j
        op[0][j] = 3
    for i in range(1, n + 1):
        ri = ref[i - 1]
        for j in range(1, m + 1):
            if ri == hyp[j - 1]:
                c_diag, o_diag = cost[i - 1][j - 1], 0
            else:
                c_diag, o_diag = cost[i - 1][j - 1] + 1, 1
            c_del = cost[i - 1][j] + 1
            c_ins = cost[i][j - 1] + 1
            # reference tie-break (calculate_wer.py:146-170): del first, then
            # ins, then diag — each replacing only on strictly smaller cost.
            # Attribution (not total distance) depends on this order.
            best, o = c_del, 2
            if c_ins < best:
                best, o = c_ins, 3
            if c_diag < best:
                best, o = c_diag, o_diag
            cost[i][j] = best
            op[i][j] = o

    stats = EditStats()
    i, j = n, m
    while i > 0 or j > 0:
        o = op[i][j]
        if o == 0:
            stats.cor += 1
            i, j = i - 1, j - 1
        elif o == 1:
            stats.sub += 1
            i, j = i - 1, j - 1
        elif o == 2:
            stats.dele += 1
            i -= 1
        else:
            stats.ins += 1
            j -= 1
    return stats


class Calculator:
    """Aggregate WER over utterances (tools/wer/calculate_wer.py:97-227 API)."""

    def __init__(self):
        self.total = EditStats()
        self.per_utt: Dict[str, EditStats] = {}

    def calculate(self, utt_id: str, lab_text: str, rec_text: str) -> EditStats:
        """Normalize both texts and accumulate alignment stats.

        Argument order mirrors the reference harness, which passes the ASR
        *transcription* as ``lab`` and the ground-truth text as ``rec``
        (calculate_wer.py:339-343) — so the aggregate WER denominator is the
        transcription token count, exactly as published.
        """
        s = edit_distance(normalize_text(lab_text), normalize_text(rec_text))
        self.per_utt[utt_id] = s
        self.total.cor += s.cor
        self.total.sub += s.sub
        self.total.ins += s.ins
        self.total.dele += s.dele
        return s

    @property
    def wer(self) -> float:
        return self.total.wer

    def report(self) -> str:
        t = self.total
        return (
            f"utterances={len(self.per_utt)} WER={100*t.wer:.2f}% "
            f"(cor={t.cor} sub={t.sub} del={t.dele} ins={t.ins})"
        )


# ---------------------------------------------------------------------------
# ASR transcription (model-backed; gated on the weight files)
# ---------------------------------------------------------------------------


def have_asr(model_dir: str) -> bool:
    """Whether ``model_dir`` holds a readable HubertForCTC directory (by its
    files; nothing is imported)."""
    return have_hf_ctc_dir(model_dir)


def ctc_logits(cfg, params: dict, wav, lengths=None):
    """Waveform (B, S) -> CTC logits (B, T, V) and frame_lengths (B,): the SSL
    tower and the reference ASR's ``lm_head`` linear."""
    out = ssl_forward(cfg, params["ssl"], wav, lengths)
    logits = F.linear(out["x"], params["lm_head"]["w"], params["lm_head"]["b"])
    frame_lengths = out.get("frame_lengths")
    if frame_lengths is None:  # unmasked run: every frame is valid
        frame_lengths = torch.full((wav.shape[0],), logits.shape[1], dtype=torch.int64, device=logits.device)
    return logits, frame_lengths


def greedy_ctc_decode(ids: np.ndarray, vocab: Dict[int, str],
                      blank_id: int = 0, word_delimiter: str = "|") -> str:
    """Collapse repeats -> drop the blank -> map ids -> join.

    Matches the reference's default ``Wav2Vec2CTCTokenizer.decode``: collapse
    THEN remove blank; other special tokens are kept verbatim (the WER
    normalization later strips ``<...>`` spans *inside* tokens, so a special
    glued between letters must stay glued — ``CA<s>A`` normalizes to ``CAA``,
    not ``CA A``); the word delimiter becomes a space.
    """
    ids = np.asarray(ids).reshape(-1)
    collapsed = [int(i) for i, prev in zip(ids, np.concatenate([[-1], ids[:-1]]))
                 if i != prev]
    toks = [vocab[i] for i in collapsed if i != blank_id and i in vocab]
    return "".join(toks).replace(word_delimiter, " ").strip()


def load_hf_ctc_params(model_dir: str, cfg=None):
    """HubertForCTC directory -> (tree, id -> token vocab, do_normalize, cfg)."""
    return read_hf_ctc_dir(model_dir, cfg)


class CTCTranscriber:
    """Greedy CTC ASR (calculate_wer.py:269-374 semantics), one utterance a
    call, padded to a power-of-two-second bucket (16000 * 2^k samples) with
    masked statistics, so a padded run equals the exact-length one.
    ``program``: ``ctc_logits`` on the weights, one program per bucket."""

    def __init__(self, model_dir: str = None, device=None, params: dict = None, cfg=None,
                 vocab: Dict[int, str] = None, do_normalize: bool = True, precision: str = "highest"):
        self.precision = precision  # "highest": TF32 off; "default": TF32 on
        self.device = resolve_device(device)
        self.cfg = cfg
        if params is None:
            if model_dir is None:
                raise ValueError("need model_dir or params")
            params, vocab, do_normalize, self.cfg = load_hf_ctc_params(model_dir, cfg)
        elif self.cfg is None:
            self.cfg = hubert_large_ft_config()
        self.params = tree_map(lambda t: t.to(self.device), params)
        self.vocab = vocab or {}
        self.do_normalize = do_normalize
        self.program = aot.CapturedProgram(self._forward, "ctc_logits")

    def _forward(self, wav: torch.Tensor, lengths: torch.Tensor) -> dict:
        logits, frame_lengths = ctc_logits(self.cfg, self.params, wav, lengths)
        return {"logits": logits, "frame_lengths": frame_lengths}

    def logits(self, wav: np.ndarray):
        """(T_valid, V) logits of one 16 kHz waveform."""
        wav = np.asarray(wav, np.float32).reshape(-1)
        if self.do_normalize:  # Wav2Vec2FeatureExtractor zero-mean unit-var
            wav = (wav - wav.mean()) / np.sqrt(wav.var() + 1e-7)
        n = max(len(wav), 800)
        padded = np.zeros((1, power_of_two_bucket(n)), np.float32)
        padded[0, : len(wav)] = wav
        with torch.no_grad(), f32_precision(self.precision):
            out = self.program(torch.from_numpy(padded).to(self.device), torch.tensor([n], device=self.device))
        return out["logits"][0, : int(out["frame_lengths"][0])]

    def transcribe(self, wav: np.ndarray, sample_rate: int = 16000) -> str:
        if sample_rate != 16000:
            raise ValueError("resample to 16 kHz on load (audio_io.load_audio)")
        ids = self.logits(wav).argmax(dim=-1).cpu().numpy()
        return greedy_ctc_decode(ids, self.vocab)
