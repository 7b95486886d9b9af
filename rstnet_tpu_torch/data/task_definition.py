"""Task-format registry and manifest loading (counterpart of
``rstnet_tpu/data/task_definition.py``, copied).

Six pretraining task formats (and the 17-stream moshi fine-tune format)
declaring keys, types and loss keys; a loader that reads per-task json
manifests pointing at offline-tokenized tensors or text shards and merges
them into memory dicts, text_only examples kept apart so the batcher can mix
them into every batch. ``.pt``, ``.npy``, ``.npz`` and whitespace text
shards are accepted; tensors become numpy on load.
"""

from __future__ import annotations

import json
import logging
from typing import Any

import numpy as np


def load_pt_data(f: str) -> dict[str, np.ndarray]:
    import torch

    data = torch.load(f, map_location="cpu", weights_only=True)
    return {k: np.asarray(v) for k, v in data.items()}


def load_npy_data(f: str) -> dict[str, np.ndarray]:
    data = np.load(f, allow_pickle=True)
    if isinstance(data, np.lib.npyio.NpzFile):
        return {k: data[k] for k in data.files}
    return dict(data.item())


def load_text_data(f: str) -> dict[str, str]:
    ret: dict[str, str] = {}
    with open(f, encoding="utf-8") as fp:
        for line in fp:
            parts = line.strip().split()
            if len(parts) < 2:
                logging.warning(f"empty manifest entry: {parts}")
                continue
            ret[parts[0]] = " ".join(parts[1:])
    return ret


def unified_loading(f: str):
    if f.endswith(".pt"):
        return load_pt_data(f)
    if f.endswith((".npy", ".npz")):
        return load_npy_data(f)
    return load_text_data(f)


loading_methods = {
    "audio": lambda f: load_pt_data(f) if f.endswith(".pt") else load_npy_data(f),
    "audio_prompt": unified_loading,
    "text": unified_loading,
}

# Each format declares: keys (components in order), type (tokenizer per key),
# sp_token (which empty-padding to add on the other modality), loss_key.
task_formats: dict[str, dict[str, Any]] = {
    "text_only": {
        "keys": ["text_seq"], "type": ["text"], "sp_token": ["zero_audio"],
        "features": [], "loss_key": ["text_seq"],
    },
    "audio_only": {
        "keys": ["audio_seq"], "type": ["audio"], "sp_token": ["zero_text"],
        "features": [], "loss_key": ["audio_seq"],
    },
    "setence_level_text_audio_interleaved": {
        "keys": ["text_seq", "audio_seq"], "type": ["text", "audio"],
        "sp_token": ["zero_text", "zero_audio"], "features": [],
        "loss_key": ["text_seq", "audio_seq"],
    },
    "segment_level_audio_text_interleaved": {
        "keys": ["audio_seq", "text_seq"], "type": ["audio", "text"],
        "sp_token": ["zero_text", "zero_audio"], "features": [],
        "loss_key": ["text_seq", "audio_seq"],
    },
    "word_level_audio_text_interleaved": {
        "keys": ["audio_seq", "text_seq"], "type": ["audio", "text"],
        "sp_token": ["zero_text", "zero_audio"], "features": [],
        "loss_key": ["text_seq", "audio_seq"],
    },
    "word_level_audio_text_alignment": {
        "keys": ["audio_seq", "text_seq"], "type": ["audio", "text"],
        "sp_token": ["zero_text", "zero_audio"], "features": [],
        "loss_key": ["audio_seq"],
    },
    # 17-stream duplex fine-tuning (text + 2x(semantic+7 acoustic)), the v1
    # moshi_ft format: the stacked grid is stored pre-built.
    "moshi_ft": {
        "keys": ["audio_seq"], "type": ["audio"], "sp_token": [False],
        "features": [], "loss_key": ["audio_seq"],
    },
}


def load_data_for_one_task(dataset_json: dict) -> dict[str, dict]:
    task_type = dataset_json["task"]
    task_format = task_formats[task_type]
    data_dict: dict[str, dict] = {}
    for key, _ in zip(task_format["keys"], task_format["type"]):
        if key not in dataset_json["keys"]:
            raise ValueError(f"task {task_type}: data key {key} missing from manifest")
        this = loading_methods[dict(zip(task_format["keys"], task_format["type"]))[key]](
            dataset_json["keys"][key]
        )
        for example_id, data in this.items():
            data_dict.setdefault(f"{task_type}_{example_id}", {})[key] = data
    # drop incomplete examples
    for example_id in list(data_dict):
        if any(k not in data_dict[example_id] for k in task_format["keys"]):
            del data_dict[example_id]
            logging.warning(f"{task_type} example {example_id} dropped: missing key")
    for example_id in data_dict:
        data_dict[example_id]["task"] = task_type
        data_dict[example_id]["loss_key"] = task_format["loss_key"]
    return data_dict


def load_data_for_all_tasks(json_files) -> tuple[dict, dict]:
    """-> (data_dict, text_dict); text_only goes to the second dict so the
    batcher can guarantee text mixing (``utils/task_definition.py:151-165``)."""
    data_dict: dict = {}
    text_dict: dict = {}
    for json_file in json_files:
        with open(json_file) as fp:
            dataset_json = json.load(fp)
        task_data = load_data_for_one_task(dataset_json)
        (text_dict if dataset_json["task"] == "text_only" else data_dict).update(task_data)
    logging.info(
        f"loaded {len(data_dict)} examples and {len(text_dict)} text-only examples"
    )
    return data_dict, text_dict
