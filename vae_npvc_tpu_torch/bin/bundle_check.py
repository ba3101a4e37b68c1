"""Smoke-check a serving bundle against offline decode outputs.

Counterpart of ``vae_npvc_tpu/bin/bundle_check.py``, the deployment gate of
recipe stage 8: convert trials through the exported programs
(``infer/export_serving.ServingBundle``) and compare to the offline
``bin/decode.py`` arks for the same trials. Offline arks are
Kaldi-compressed, so the pass tolerance is compression-level; the bit-exact
program-vs-live check lives in tests/test_torch_port_export_serving.py.
``--device`` (default ``cuda``) is where the bundle runs.

Usage:
    python -m vae_npvc_tpu_torch.bin.bundle_check \
        --bundle exp/.../serving_bundle --decode_dir dump/eval \
        --offline_scp exp/.../outputs/.../feats.scp
"""

from __future__ import annotations

import argparse


def main(argv=None):
    parser = argparse.ArgumentParser(
        description="Compare serving-bundle conversion to offline decode "
                    "outputs")
    parser.add_argument("--bundle", required=True)
    parser.add_argument("--decode_dir", required=True,
                        help="dir with trials + feats.scp (+ spk2spk_id)")
    parser.add_argument("--offline_scp", required=True,
                        help="feats.scp written by bin/decode.py for the "
                             "same trials")
    parser.add_argument("--max_utts", type=int, default=4)
    parser.add_argument("--tol", type=float, default=1e-4,
                        help="absolute floor added to the per-column "
                             "compression step bound")
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)

    from pathlib import Path

    import numpy as np

    from ..data import kaldi_io
    from ..infer.export_serving import ServingBundle

    decode_dir = Path(args.decode_dir)
    bundle = ServingBundle(args.bundle, device=args.device)
    feats_scp = kaldi_io.load_dict_data(decode_dir / "feats.scp")
    offline = kaldi_io.load_dict_data(args.offline_scp)
    trials = kaldi_io.load_list_data(decode_dir / "trials")

    # a source utt may appear in several trial lines with different targets
    # (random trials, make_trials.py -n); decode writes them all and the
    # scp's LAST entry wins — compare against that line's targets
    per_utt: dict = {}
    for parts in trials:
        per_utt[parts[0]] = list(parts[1:])
    items, utts = [], []
    for utt, targets in per_utt.items():
        if len(items) >= args.max_utts:
            break
        if utt not in offline:
            continue
        if utt not in feats_scp:
            raise SystemExit(
                f"bundle_check: trial utterance {utt!r} missing from "
                f"{decode_dir}/feats.scp — is --decode_dir the dump dir "
                f"stage 5 decoded?")
        items.append((kaldi_io.load_mat(feats_scp[utt]), targets))
        utts.append(utt)
    if not items:
        raise SystemExit("bundle_check: no trials overlap the offline scp")

    outs = bundle.convert(items)
    # the offline arks are Kaldi-compressed (format 1: per-column
    # percentile segments, uint8 codes), so the comparison must be
    # compression-aware: round-trip the bundle output through the SAME
    # codec, then allow ~1 code step per element (the two sides sit on the
    # same quantization grid; a boundary-straddling element can differ by
    # one step). Per-column step bound = the coarsest of the 3 segments.
    import tempfile

    n_bad, n_total = 0, 0
    worst_steps = 0.0
    with tempfile.TemporaryDirectory() as td:
        rt_scp = f"{td}/rt.scp"
        with kaldi_io.write_helper(
                f"ark,scp:{td}/rt.ark,{rt_scp}", compression_method=1) as wf:
            for utt, out in zip(utts, outs):
                wf[utt] = out
        rts = kaldi_io.load_dict_data(rt_scp)
        for utt, out in zip(utts, outs):
            ref = np.asarray(kaldi_io.load_mat(offline[utt]))
            if out.shape != ref.shape:
                raise SystemExit(
                    f"bundle_check FAIL: {utt} shape {out.shape} != offline "
                    f"{ref.shape}")
            rt = np.asarray(kaldi_io.load_mat(rts[utt]))
            p0, p25, p75, p100 = np.percentile(ref, [0, 25, 75, 100], axis=0)
            step = np.maximum.reduce([(p25 - p0) / 64.0,
                                      (p75 - p25) / 128.0,
                                      (p100 - p75) / 63.0])
            tol = 1.5 * step + args.tol
            steps = np.abs(rt - ref) / np.maximum(tol, 1e-12)
            n_bad += int((steps > 1.0).sum())
            n_total += steps.size
            worst_steps = max(worst_steps, float(steps.max()))
    # a tiny out-of-bound fraction is tolerated: the offline decode batches
    # a bucket's last chunk at its own size while the bundle pads it to the
    # exported batch, so a near-tie codebook argmin can flip for isolated
    # frames (another reduction order) — that is not a deployment defect
    frac_bad = n_bad / max(n_total, 1)
    status = "PASS" if frac_bad <= 5e-3 else "FAIL"
    print(f"bundle_check {status}: {len(utts)} utts, "
          f"{100 * frac_bad:.3f}% elements beyond the per-column "
          f"compression step bound (worst {worst_steps:.2f}x, "
          f"fail above 0.5%)")
    if status == "FAIL":
        raise SystemExit(1)


if __name__ == "__main__":
    main()
