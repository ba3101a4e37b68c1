"""The port's ``bin/doctor`` and ``utils/plot_metrics`` on the CPU.

One counterpart of each case of ``tests/test_doctor.py`` (healthy host
with ``--device cpu``, a wedged device probe reported instead of hung, the
bundle check, human output) and of ``tests/test_plot_metrics.py``. Besides:
a ``.json`` config for the model check with its K1/K2 launch counts (0 on
the CPU, where the wrappers take the plain versions), and ``--device cuda``
on a host without a GPU reported as a failure, not run on the CPU.
"""

import json

import numpy as np
import torch

from tests.toy_config import toy_config
from vae_npvc_tpu_torch.bin import doctor

torch.set_num_threads(1)

REQUIRED = ("imports", "platform", "devices", "cpu-fallback",
            "compile-cache")


def _json(capsys):
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def test_doctor_ok(capsys, tmp_path):
    cfg = tmp_path / "conf.json"
    cfg.write_text(json.dumps(toy_config()))
    rc = doctor.main(["--device", "cpu", "--config", str(cfg),
                      "--timeout", "600", "--json"])
    out = _json(capsys)
    assert rc == 0, out
    assert out["ok"] is True
    for name in REQUIRED + ("model",):
        assert out["checks"][name]["status"] in ("ok", "warn"), \
            out["checks"][name]
    for name in ("imports", "platform", "devices", "cpu-fallback", "model"):
        assert out["checks"][name]["status"] == "ok", out["checks"][name]
    model = out["checks"]["model"]
    assert " params" in model["detail"] and "infer out (1, 64, 10)" \
        in model["detail"]
    assert model["launches"] == {"vq_fused": 0, "fused_group_norm": 0}
    assert "native loader ark_loader-" in \
        out["checks"]["compile-cache"]["detail"]


def test_doctor_reports_wedged_probe_instead_of_hanging(monkeypatch, capsys):
    import time as _time

    def hang(device):
        _time.sleep(3600)

    monkeypatch.setattr(doctor, "_device_probe", hang)
    rc = doctor.main(["--device", "cpu", "--timeout", "0.5", "--json"])
    out = _json(capsys)
    assert rc == 1
    assert out["ok"] is False
    assert out["checks"]["devices"]["status"] == "FAIL"
    assert "timed out" in out["checks"]["devices"]["detail"]
    # later device-touching checks are skipped, not blocked on the same
    # device with a misleading cascade
    assert out["checks"]["cpu-fallback"]["status"] == "skip"
    assert "wedged" in out["checks"]["cpu-fallback"]["detail"]


def test_doctor_bundle_check(capsys, tmp_path):
    from vae_npvc_tpu_torch.infer.export_serving import export_bundle
    from vae_npvc_tpu_torch.train import build_trainer

    cfg = dict(toy_config(), compute_dtype="float32")
    tr = build_trainer(cfg, device="cpu")
    tr.init_state()
    rng = np.random.default_rng(0)
    tr.train_step((rng.normal(size=(2, 32, 10)).astype(np.float32),
                   np.zeros((2,), np.int32)))
    ck = tmp_path / "m.ckpt"
    tr.save_checkpoint(ck)
    export_bundle(cfg, ck, tmp_path / "bundle", buckets=[32], batch_size=2,
                  device="cpu")

    rc = doctor.main(["--device", "cpu", "--bundle",
                      str(tmp_path / "bundle"), "--timeout", "600",
                      "--json"])
    out = _json(capsys)
    assert rc == 0, out
    assert out["checks"]["bundle"]["status"] == "ok"
    assert "1 bucket(s)" in out["checks"]["bundle"]["detail"]

    rc = doctor.main(["--device", "cpu", "--bundle", str(tmp_path / "no"),
                      "--timeout", "600", "--json"])
    out = _json(capsys)
    assert rc == 1
    assert out["checks"]["bundle"]["status"] == "FAIL"


def test_doctor_human_output(capsys):
    rc = doctor.main(["--device", "cpu", "--timeout", "600"])
    text = capsys.readouterr().out
    assert rc == 0
    assert "devices" in text and "compile-cache" in text
    assert "doctor: FAILED" not in text


def test_doctor_cuda_without_a_gpu_fails(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rc = doctor.main(["--timeout", "600", "--json"])
    out = _json(capsys)
    assert rc == 1
    assert out["checks"]["platform"]["status"] == "FAIL"
    assert "no CUDA GPU" in out["checks"]["platform"]["detail"]
    assert out["checks"]["devices"]["status"] == "FAIL"
    assert out["checks"]["cpu-fallback"]["status"] == "ok"


def test_doctor_compile_cache_without_nvcc(monkeypatch):
    from vae_npvc_tpu_torch.ops import _build

    def no_nvcc():
        raise RuntimeError("nvcc not found")

    monkeypatch.setattr(_build, "_nvcc", no_nvcc)
    status, detail = doctor._check_cache("cpu", 600)
    assert status == "warn" and "nvcc not found" in detail
    assert doctor._check_cache("cuda", 600)[0] == "FAIL"


def test_plot_metrics_renders(tmp_path):
    from vae_npvc_tpu_torch.utils.plot_metrics import main

    rows = [
        {"iter": 100, "split": "train", "Total": 9.0, "X like": 8.9,
         "frames_per_sec": 1000.0},
        {"iter": 200, "split": "train", "Total": 8.0, "X like": 7.9,
         "frames_per_sec": 1100.0},
        {"iter": 200, "split": "valid", "best_iter": 200, "Total": 8.1,
         "X like": 8.0},
    ]
    mfile = tmp_path / "metrics.jsonl"
    mfile.write_text("".join(json.dumps(r) + "\n" for r in rows))
    main([str(mfile)])
    png = tmp_path / "metrics.png"
    assert png.exists() and png.stat().st_size > 10_000
