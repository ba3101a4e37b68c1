"""Random train/valid split of a Kaldi data dir.

Counterpart of ``vae_npvc_tpu/bin/subset_data_into_tr_cv.py`` (the port's
own copy): shuffle the utterance indices with Python's ``random`` (seeded
by ``--seed``, so a seed gives the JAX package's split), write
``wav.scp``/``feats.scp``/``utt2num_frames``/``utt2spk`` for each subset,
order-preserving within the shuffled selection.

Usage:
    python -m vae_npvc_tpu_torch.bin.subset_data_into_tr_cv data/all \
        data/train data/valid -nt 1000 -nv 50 --seed 777
"""

from __future__ import annotations

import argparse
import random
from pathlib import Path

from ..data.kaldi_io import load_dict_data

FILES = ("wav.scp", "feats.scp", "utt2num_frames", "utt2spk")


def subset(data_dir, train_dir, valid_dir, num_train, num_valid, seed=None):
    data_dir = Path(data_dir)
    train_dir = Path(train_dir)
    valid_dir = Path(valid_dir)
    train_dir.mkdir(parents=True, exist_ok=True)
    valid_dir.mkdir(parents=True, exist_ok=True)

    tables = {f: load_dict_data(data_dir / f) for f in FILES
              if (data_dir / f).exists()}
    utt_list = list(tables["utt2spk"].keys())
    assert len(utt_list) >= num_train + num_valid, (
        f"Number of all data ({len(utt_list)}) is smaller than the number of "
        f"subset data ({num_train + num_valid})")

    idx = list(range(len(utt_list)))
    if seed is not None:
        random.seed(seed)
    random.shuffle(idx)
    splits = {
        train_dir: [utt_list[i] for i in sorted(idx[:num_train])],
        valid_dir: [utt_list[i] for i in
                    sorted(idx[num_train:num_train + num_valid])],
    }
    for out_dir, utts in splits.items():
        for fname, table in tables.items():
            with open(out_dir / fname, "w") as wf:
                for utt in utts:
                    if utt in table:
                        wf.write(f"{utt} {table[utt]}\n")
    return splits


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("data_dir", type=str)
    parser.add_argument("train_data_dir", type=str)
    parser.add_argument("valid_data_dir", type=str)
    parser.add_argument("-nt", "--num_training_data", type=int,
                        required=True)
    parser.add_argument("-nv", "--num_validation_data", type=int,
                        required=True)
    parser.add_argument("--seed", type=int, default=None)
    args = parser.parse_args(argv)
    return subset(args.data_dir, args.train_data_dir, args.valid_data_dir,
                  args.num_training_data, args.num_validation_data,
                  args.seed)


if __name__ == "__main__":
    main()
