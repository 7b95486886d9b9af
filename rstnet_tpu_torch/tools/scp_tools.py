"""scp manipulation utilities — the Kaldi-Perl replacement (a copy of
``rstnet_tpu/tools/scp_tools.py``).

Capability parity with the reference's data-prep helpers: ``split_scp.pl``
(``tools/kaldi/utils``), ``filter_scp.py``, ``merge_then_split.py``
(``MLLM_v2/tools/data_scripts/``). An scp file is lines of
``<utt_id> <payload>``.
"""

from __future__ import annotations

import argparse
import os
from pathlib import Path


def read_scp(path: str) -> list[tuple[str, str]]:
    out = []
    with open(path, encoding="utf-8") as f:
        for line in f:
            parts = line.strip().split(maxsplit=1)
            if len(parts) == 2:
                out.append((parts[0], parts[1]))
            elif len(parts) == 1 and parts[0]:
                out.append((parts[0], ""))
    return out


def write_scp(path: str, entries: list[tuple[str, str]]) -> None:
    os.makedirs(os.path.dirname(str(path)) or ".", exist_ok=True)
    with open(path, "w", encoding="utf-8") as f:
        for k, v in entries:
            f.write(f"{k} {v}\n".rstrip() + "\n" if not v else f"{k} {v}\n")


def split_scp(path: str, n: int, out_pattern: str) -> list[str]:
    """Split into n balanced shards (split_scp.pl). out_pattern must contain
    ``JOB``; 1-indexed like Kaldi."""
    entries = read_scp(path)
    outs = []
    for j in range(n):
        shard = entries[j::n]
        out = out_pattern.replace("JOB", str(j + 1))
        write_scp(out, shard)
        outs.append(out)
    return outs


def filter_scp(scp: str, keep_list: str, out: str, exclude: bool = False) -> int:
    keys = {k for k, _ in read_scp(keep_list)}
    entries = read_scp(scp)
    kept = [(k, v) for k, v in entries if (k in keys) != exclude]
    write_scp(out, kept)
    return len(kept)


def merge_then_split(inputs: list[str], n: int, out_pattern: str) -> list[str]:
    entries = []
    for p in inputs:
        entries.extend(read_scp(p))
    tmp = out_pattern.replace("JOB", "all") + ".merged"
    write_scp(tmp, entries)
    outs = split_scp(tmp, n, out_pattern)
    os.remove(tmp)
    return outs


def find_peer_utts(scp: str, out: str, sep: str = "_") -> int:
    """Group utterances sharing a prefix (speaker/conversation) and emit
    ``utt peer`` pairs — prompt-selection helper
    (``tools/data_scripts/find_peer_utts.py``)."""
    entries = read_scp(scp)
    by_prefix: dict[str, list[str]] = {}
    for k, _ in entries:
        by_prefix.setdefault(k.rsplit(sep, 1)[0], []).append(k)
    pairs = []
    for group in by_prefix.values():
        for i, utt in enumerate(group):
            peer = group[(i + 1) % len(group)]
            if peer != utt:
                pairs.append((utt, peer))
    write_scp(out, pairs)
    return len(pairs)


def select_spk2utt(scp: str, out: str, max_per_spk: int, sep: str = "_") -> int:
    """Cap utterances per speaker prefix
    (``tools/data_scripts/select_spk2utt.py``)."""
    counts: dict[str, int] = {}
    kept = []
    for k, v in read_scp(scp):
        spk = k.rsplit(sep, 1)[0]
        if counts.get(spk, 0) < max_per_spk:
            counts[spk] = counts.get(spk, 0) + 1
            kept.append((k, v))
    write_scp(out, kept)
    return len(kept)


def wav_dir_to_scp(wav_dir: str, out: str) -> int:
    """Build a wav.scp from a directory tree (get_wav.py equivalent)."""
    entries = []
    for p in sorted(Path(wav_dir).rglob("*.wav")):
        entries.append((p.stem, str(p)))
    write_scp(out, entries)
    return len(entries)


def main(argv=None):
    parser = argparse.ArgumentParser(description="scp utilities")
    sub = parser.add_subparsers(dest="cmd", required=True)
    p_split = sub.add_parser("split")
    p_split.add_argument("scp")
    p_split.add_argument("n", type=int)
    p_split.add_argument("out_pattern", help="must contain JOB")
    p_filter = sub.add_parser("filter")
    p_filter.add_argument("scp")
    p_filter.add_argument("keep_list")
    p_filter.add_argument("out")
    p_filter.add_argument("--exclude", action="store_true")
    p_merge = sub.add_parser("merge-split")
    p_merge.add_argument("inputs", nargs="+")
    p_merge.add_argument("--n", type=int, required=True)
    p_merge.add_argument("--out_pattern", required=True)
    p_wav = sub.add_parser("from-dir")
    p_wav.add_argument("wav_dir")
    p_wav.add_argument("out")
    args = parser.parse_args(argv)
    if args.cmd == "split":
        print("\n".join(split_scp(args.scp, args.n, args.out_pattern)))
    elif args.cmd == "filter":
        print(filter_scp(args.scp, args.keep_list, args.out, args.exclude))
    elif args.cmd == "merge-split":
        print("\n".join(merge_then_split(args.inputs, args.n, args.out_pattern)))
    elif args.cmd == "from-dir":
        print(wav_dir_to_scp(args.wav_dir, args.out))


if __name__ == "__main__":
    main()
