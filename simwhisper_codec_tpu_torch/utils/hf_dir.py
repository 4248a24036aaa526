"""Hugging Face ``HubertForCTC`` model directories, read and written by their files.

The counterpart of what ``transformers.from_pretrained`` does for the JAX
package's ``load_hf_ctc_params`` (``simwhisper_codec_tpu/eval/wer.py:270-305``),
without ``transformers`` or ``safetensors``:

  config.json               the encoder geometry and ``vocab_size``
  model.safetensors         8-byte little-endian header length, a JSON header,
                            then raw F32 / F16 / BF16 data (or pytorch_model.bin,
                            read with ``torch.load``)
  vocab.json                token -> id (plus added_tokens.json where present)
  preprocessor_config.json  ``do_normalize``

``write_hf_ctc_dir`` writes the same files (tokenizer_config.json and
special_tokens_map.json too), so ``transformers`` loads what it writes.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Dict, Tuple

import numpy as np
import torch

from simwhisper_codec_tpu_torch.models.ssl import SSLConfig
from simwhisper_codec_tpu_torch.utils.ssl_checkpoint import convert_hf_ssl, to_tensor

CONFIG = "config.json"
SAFETENSORS = "model.safetensors"
TORCH_BIN = "pytorch_model.bin"
VOCAB = "vocab.json"
PREPROCESSOR = "preprocessor_config.json"

_DTYPES = {"F32": np.float32, "F16": np.float16, "F64": np.float64, "I64": np.int64, "I32": np.int32}


def read_safetensors(path) -> Dict[str, torch.Tensor]:
    """A ``.safetensors`` file -> {name: CPU tensor} (BF16 widened to f32)."""
    raw = np.fromfile(path, dtype=np.uint8)  # one read; the tensors are views of it
    n = int(raw[:8].view("<u8")[0])
    header = json.loads(raw[8: 8 + n].tobytes())
    data = raw[8 + n:]
    out = {}
    for name, meta in header.items():
        if name == "__metadata__":
            continue
        begin, end = meta["data_offsets"]
        if meta["dtype"] == "BF16":
            arr = (data[begin:end].view("<u2").astype(np.uint32) << 16).view(np.float32)
        else:
            arr = data[begin:end].view(np.dtype(_DTYPES[meta["dtype"]]).newbyteorder("<"))
        out[name] = torch.from_numpy(arr.reshape(tuple(meta["shape"])))
    return out


def write_safetensors(path, tensors: Dict[str, torch.Tensor]) -> None:
    """{name: f32 tensor} -> a ``.safetensors`` file (header padded to 8 bytes)."""
    header, blobs, offset = {}, [], 0
    for name, t in tensors.items():
        a = np.ascontiguousarray(t.detach().cpu().numpy(), np.float32)
        header[name] = {"dtype": "F32", "shape": list(a.shape), "data_offsets": [offset, offset + a.nbytes]}
        blobs.append(a.tobytes())
        offset += a.nbytes
    header["__metadata__"] = {"format": "pt"}
    head = json.dumps(header, separators=(",", ":")).encode()
    head += b" " * (-len(head) % 8)
    with open(path, "wb") as f:
        f.write(len(head).to_bytes(8, "little"))
        f.write(head)
        for b in blobs:
            f.write(b)


def have_hf_ctc_dir(path) -> bool:
    """config.json, the weights and vocab.json are present (imports nothing)."""
    p = Path(path)
    return (p / CONFIG).is_file() and (p / VOCAB).is_file() and ((p / SAFETENSORS).is_file()
                                                                  or (p / TORCH_BIN).is_file())


def ssl_config_from_hf(hc: dict) -> SSLConfig:
    """The keys the JAX loader reads from an HF config (wer.py:285-298)."""
    return SSLConfig(
        d_model=hc["hidden_size"],
        num_layers=hc["num_hidden_layers"],
        num_heads=hc["num_attention_heads"],
        ffn_dim=hc["intermediate_size"],
        pre_ln=hc["do_stable_layer_norm"],
        conv_dims=tuple(hc["conv_dim"]),
        conv_kernels=tuple(hc["conv_kernel"]),
        conv_strides=tuple(hc["conv_stride"]),
        conv_bias=hc["conv_bias"],
        extract_norm=hc["feat_extract_norm"],
        conv_pos_kernel=hc["num_conv_pos_embeddings"],
        conv_pos_groups=hc["num_conv_pos_embedding_groups"],
    )


def read_state_dict(path) -> Dict[str, torch.Tensor]:
    p = Path(path)
    if (p / SAFETENSORS).is_file():
        return read_safetensors(p / SAFETENSORS)
    return torch.load(p / TORCH_BIN, map_location="cpu", weights_only=True)


def read_hf_ctc_dir(path, cfg: SSLConfig = None) -> Tuple[dict, Dict[int, str], bool, SSLConfig]:
    """HubertForCTC directory -> (tree {"ssl", "lm_head"}, id -> token,
    do_normalize, SSLConfig)."""
    p = Path(path)
    cfg = cfg or ssl_config_from_hf(json.loads((p / CONFIG).read_text()))
    sd = read_state_dict(p)
    params = {"ssl": convert_hf_ssl(sd, cfg, prefix="hubert."),
              "lm_head": {"w": to_tensor(sd["lm_head.weight"]), "b": to_tensor(sd["lm_head.bias"])}}
    tokens = json.loads((p / VOCAB).read_text())
    if (p / "added_tokens.json").is_file():
        tokens.update(json.loads((p / "added_tokens.json").read_text()))
    do_normalize = True  # Wav2Vec2FeatureExtractor's default
    if (p / PREPROCESSOR).is_file():
        do_normalize = bool(json.loads((p / PREPROCESSOR).read_text()).get("do_normalize", True))
    return params, {i: t for t, i in tokens.items()}, do_normalize, cfg


def hf_hubert_config(cfg: SSLConfig, vocab_size: int) -> dict:
    """config.json of a HubertForCTC at ``cfg`` (HubertConfig's other defaults)."""
    return {
        "architectures": ["HubertForCTC"], "model_type": "hubert",
        "hidden_size": cfg.d_model, "num_hidden_layers": cfg.num_layers,
        "num_attention_heads": cfg.num_heads, "intermediate_size": cfg.ffn_dim,
        "do_stable_layer_norm": cfg.pre_ln, "feat_extract_norm": cfg.extract_norm,
        "conv_dim": list(cfg.conv_dims), "conv_kernel": list(cfg.conv_kernels),
        "conv_stride": list(cfg.conv_strides), "num_feat_extract_layers": len(cfg.conv_dims),
        "conv_bias": cfg.conv_bias, "num_conv_pos_embeddings": cfg.conv_pos_kernel,
        "num_conv_pos_embedding_groups": cfg.conv_pos_groups, "layer_norm_eps": cfg.layer_norm_eps,
        "vocab_size": vocab_size, "hidden_act": "gelu", "feat_extract_activation": "gelu",
        "feat_proj_layer_norm": True, "conv_pos_batch_norm": False, "use_weighted_layer_sum": False,
        "hidden_dropout": 0.1, "activation_dropout": 0.1, "attention_dropout": 0.1, "feat_proj_dropout": 0.0,
        "final_dropout": 0.1, "layerdrop": 0.1, "initializer_range": 0.02, "apply_spec_augment": True,
        "mask_time_prob": 0.05, "mask_time_length": 10, "mask_time_min_masks": 2, "mask_feature_prob": 0.0,
        "mask_feature_length": 10, "mask_feature_min_masks": 0, "ctc_loss_reduction": "sum",
        "ctc_zero_infinity": False, "pad_token_id": 0, "bos_token_id": 1, "eos_token_id": 2,
    }


def write_hf_ctc_dir(path, cfg: SSLConfig, state_dict: Dict[str, torch.Tensor], vocab: Dict[str, int]) -> None:
    """Write a HubertForCTC directory: ``state_dict`` in HF keys (``hubert.*``,
    ``lm_head.*``), the CTC vocabulary token -> id."""
    p = Path(path)
    p.mkdir(parents=True, exist_ok=True)
    (p / CONFIG).write_text(json.dumps(hf_hubert_config(cfg, len(vocab)), indent=2))
    write_safetensors(p / SAFETENSORS, state_dict)
    (p / VOCAB).write_text(json.dumps(vocab, indent=2))
    special = {"bos_token": "<s>", "eos_token": "</s>", "pad_token": "<pad>", "unk_token": "<unk>"}
    (p / "special_tokens_map.json").write_text(json.dumps(special, indent=2))
    (p / "tokenizer_config.json").write_text(json.dumps(dict(
        special, tokenizer_class="Wav2Vec2CTCTokenizer", word_delimiter_token="|", do_lower_case=False,
        replace_word_delimiter_char=" "), indent=2))
    (p / PREPROCESSOR).write_text(json.dumps({
        "feature_extractor_type": "Wav2Vec2FeatureExtractor", "feature_size": 1, "sampling_rate": 16000,
        "padding_value": 0.0, "padding_side": "right", "do_normalize": True,
        "return_attention_mask": True}, indent=2))
