"""Build per-task data manifests (counterpart of
``rstnet_tpu/tools/create_data_json.py``).

Capability parity with ``MLLM_v2/tools/data_scripts/create_data_json.py``:
emit ``{"task": ..., "keys": {audio_seq: shard, text_seq: shard}}`` jsons
that the training data layer consumes.
"""

from __future__ import annotations

import argparse
import json
import os


def main(argv=None) -> None:
    parser = argparse.ArgumentParser()
    parser.add_argument("--task", required=True)
    parser.add_argument("--audio_seq", default="")
    parser.add_argument("--text_seq", default="")
    parser.add_argument("--output", required=True)
    args = parser.parse_args(argv)
    keys = {}
    if args.audio_seq:
        keys["audio_seq"] = args.audio_seq
    if args.text_seq:
        keys["text_seq"] = args.text_seq
    os.makedirs(os.path.dirname(os.path.abspath(args.output)), exist_ok=True)
    with open(args.output, "w") as f:
        json.dump({"task": args.task, "keys": keys}, f, indent=2)
    print(args.output)


if __name__ == "__main__":
    main()
