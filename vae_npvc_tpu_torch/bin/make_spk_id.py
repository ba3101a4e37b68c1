"""Build ``spk2spk_id``/``utt2spk_id`` for a Kaldi data dir.

Counterpart of ``vae_npvc_tpu/bin/make_spk_id.py``: a zero-padded 6-digit
integer id per speaker in ``spk2utt`` order; ``--spk2spk_id`` reuses an
existing map (copied in, the old one moved to ``.backup/``) so dev and
eval dirs share the training ids.

Usage:
    python -m vae_npvc_tpu_torch.bin.make_spk_id data/train
    python -m vae_npvc_tpu_torch.bin.make_spk_id data/eval \
        --spk2spk_id data/train/spk2spk_id
"""

from __future__ import annotations

import argparse
import os
from pathlib import Path
from shutil import copyfile

from ..data.kaldi_io import load_dict_data, save_dict_data


def make_spk_id(data_dir, spk2spk_id_file="", write_utt2spk_id=True):
    data_dir = Path(data_dir)

    if not spk2spk_id_file:
        if (data_dir / "spk2spk_id").exists():
            spk2spk_id = load_dict_data(data_dir / "spk2spk_id")
            print(f"{data_dir / 'spk2spk_id'} exists, use it "
                  f"({len(spk2spk_id)} speakers).")
        else:
            spk2utt_path = data_dir / "spk2utt"
            if not spk2utt_path.exists():
                raise FileNotFoundError(f"{spk2utt_path} does not exist")
            spk2utt = load_dict_data(spk2utt_path)
            spk2spk_id = {spk: f"{i:06d}" for i, spk in enumerate(spk2utt)}
            save_dict_data(data_dir / "spk2spk_id", spk2spk_id)
            print(f"Generated spk2spk_id for {len(spk2spk_id)} speakers.")
    else:
        src = Path(spk2spk_id_file)
        if not src.exists():
            raise FileNotFoundError(f"No such file {src}")
        dst = data_dir / "spk2spk_id"
        if dst.exists() and str(dst) != str(src):
            backup = data_dir / ".backup"
            backup.mkdir(parents=True, exist_ok=True)
            os.rename(dst, backup / "spk2spk_id")
        copyfile(src, dst)
        spk2spk_id = load_dict_data(src)
        print(f"Copied spk2spk_id ({len(spk2spk_id)} speakers).")

    if write_utt2spk_id:
        utt2spk = load_dict_data(data_dir / "utt2spk")
        out = {}
        for utt, spk in utt2spk.items():
            if spk not in spk2spk_id:
                print(f'Warning: speaker "{spk}" not in the speaker id list')
                continue
            out[utt] = spk2spk_id[spk]
        save_dict_data(data_dir / "utt2spk_id", out)
        print(f"Wrote utt2spk_id for {len(out)} utterances.")
    return spk2spk_id


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("data_dir", help="input data dir")
    parser.add_argument("--spk2spk_id", type=str, default="",
                        help="existing spk2spk_id file to reuse")
    parser.add_argument("--write_utt2spk_id", type=str, default="true")
    args = parser.parse_args(argv)
    make_spk_id(args.data_dir, args.spk2spk_id,
                args.write_utt2spk_id.lower() == "true")


if __name__ == "__main__":
    main()
