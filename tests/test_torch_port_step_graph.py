"""The trainer's CUDA-graph step, on the CPU: what stays eager, and the
eager step's numbers with the training state written in place.

The graphed step itself runs on the card only
(``tests/test_torch_port_cuda.py -k graph``). Here the windowed step of a
CPU trainer, of a trainer with a mesh and of the WGAN-GP trainer runs
eager and captures nothing; ``Trainer.eager_steps`` holds every trainer
eager for its block alone; the eager step keeps the numbers it read
before its optimizer state was written in place (recorded on this path
before that change); and ``spans.device_span`` records nothing while a
stream is being captured.
"""

import contextlib

import numpy as np
import pytest
import torch

from vae_npvc_tpu_torch.train import build_trainer
from vae_npvc_tpu_torch.train.trainer import Trainer
from vae_npvc_tpu_torch.utils import spans

CFG = {"model_type": "vae_npvc.model.vqvae", "seed": 7, "y_dim": 8,
       "y_num": 3, "z_dim": 8, "z_num": 16, "use_ema": True,
       "beta": 0.01, "mu": 0.9, "jitter_p": 0.0, "optim_type": "Adam",
       "learning_rate": 1e-3, "max_grad_norm": 10, "crop_length": 16,
       "lr_scheduler": "StepLR", "lr_param": {"step_size": 2, "gamma": 0.5},
       "compute_dtype": "float32",
       "encoder": {"in_channels": [10], "out_channels": [12],
                   "kernel_size": 3, "downsample_scales": [1],
                   "z_channels": 8, "dilation": False,
                   "stack_kernel_size": 3, "stack_layers": 1,
                   "stacks": [1], "use_weight_norm": True},
       "decoder": {"in_channels": [8], "out_channels": [12],
                   "cond_channels": 8, "skip_channels": 8,
                   "final_channels": 10, "kernel_size": 3,
                   "upsample_scales": [1], "dilation": False,
                   "stack_kernel_size": 3, "stacks": [1],
                   "use_weight_norm": True}}

GAN_CFG = dict(CFG, trainer_type="wgan_gp", pre_iter=-1, gamma=0.5,
               discriminator={"channels": [16, 32], "kernel_size": 5,
                              "strides": [2, 2]})

# five windowed steps of four rows, in calls of three and two; the third
# step takes utterance 0, whose frame 2 is infinite
IDX = np.array([[1, 2, 3, 4], [5, 3, 2, 1], [0, 1, 2, 3], [4, 5, 1, 2],
                [3, 2, 5, 4]])
STARTS = np.array([[0, 1, 2, 3], [4, 5, 0, 1], [0, 3, 2, 1], [2, 2, 1, 0],
                   [1, 0, 3, 2]])

# the eager step's readings before Adam's state was written in place
RECORDED = {
    "Total": [14.299304962158203, 14.072650909423828, np.nan,
              14.395096778869629, 14.47452449798584],
    "grad_norm": [1.0659478902816772, 1.0628122091293335, np.nan,
                  1.065102219581604, 1.2534739971160889],
    "skipped_nonfinite": [0.0, 0.0, 1.0, 0.0, 0.0],
    "usage": [16.0, 15.0, 14.0, 16.0, 15.0],
}
# ||flat||, ||mu||, ||nu||, ||codebook|| after the five steps
RECORDED_NORMS = [12.892282485961914, 1.0731558799743652,
                  0.0016024122014641762, 6.3921709060668945]


class Corpus:
    """Six utterances of 10 channels, padded to 40 frames."""

    crop_length = 16

    def padded_arrays(self):
        rng = np.random.default_rng(3)
        feats = rng.normal(size=(6, 40, 10)).astype(np.float32)
        feats[0, 2, 4] = np.inf
        return (feats, np.array([30, 20, 24, 40, 18, 33], np.int32),
                np.array([0, 1, 2, 0, 1, 2], np.int32))


def _run(tr, staged=False):
    if not staged:
        tr.init_state()
        tr.stage_dataset(Corpus(), 4)
    details = [tr.train_steps_indices(IDX[:3], STARTS[:3]),
               tr.train_steps_indices(IDX[3:], STARTS[3:])]
    return {k: torch.cat([d[k] for d in details]).tolist()
            for k in details[0]}


def test_eager_windowed_step_keeps_its_numbers_with_state_in_place():
    tr = build_trainer(CFG, device="cpu")
    tr.init_state()
    tr.stage_dataset(Corpus(), 4)
    state = [t.data_ptr() for t in tr.opt_state]
    flat = tr.flat.data_ptr()
    got = _run(tr, staged=True)
    for key, want in RECORDED.items():
        np.testing.assert_allclose(got[key], want, rtol=1e-5, atol=0,
                                   equal_nan=True, err_msg=key)
    st = tr.opt_state
    np.testing.assert_allclose(
        [float(tr.flat.norm()), float(st.mu.norm()), float(st.nu.norm()),
         float(tr.model.quantizer.emb.norm())], RECORDED_NORMS, rtol=1e-5)
    assert (int(st.count), int(st.sched_count), tr.iteration) == (4, 4, 5)
    # every step wrote the same tensors
    assert [t.data_ptr() for t in st] == state
    assert tr.flat.data_ptr() == flat


def _mesh_trainer(tmp_path):
    import torch.distributed as dist

    from vae_npvc_tpu_torch.parallel.mesh import make_mesh

    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/pg",
                            rank=0, world_size=1)
    return build_trainer(CFG, device="cpu", mesh=make_mesh())


@pytest.mark.parametrize("kind", ["cpu", "mesh", "gan"])
def test_trainers_that_stay_eager_never_capture(kind, tmp_path):
    import torch.distributed as dist

    captures, replays = Trainer.graph_captures, Trainer.graph_replays
    try:
        tr = {"cpu": lambda: build_trainer(CFG, device="cpu"),
              "mesh": lambda: _mesh_trainer(tmp_path),
              "gan": lambda: build_trainer(GAN_CFG, device="cpu")}[kind]()
        detail = _run(tr)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    assert len(detail["grad_norm"]) == 5 and tr.iteration == 5
    assert (Trainer.graph_captures, Trainer.graph_replays) == \
        (captures, replays)
    assert not tr._graphs
    # the gate: on a CUDA device only the plain trainer without a mesh
    # would take the graph
    tr.device = torch.device("cuda")
    assert tr._graphed() == (kind == "cpu")
    assert type(tr).supports_graphs == (kind != "gan")


@pytest.mark.parametrize("exit_by", ["return", "raise"])
def test_eager_steps_holds_every_trainer_eager_for_its_block(exit_by):
    tr = build_trainer(CFG, device="cpu")
    other = build_trainer(CFG, device="cpu")
    # the gate reads the device: as on a CUDA device
    tr.device = other.device = torch.device("cuda")
    assert tr._graphed() and other._graphed()
    with pytest.raises(RuntimeError) if exit_by == "raise" \
            else contextlib.nullcontext():
        with Trainer.eager_steps():
            assert not tr._graphed() and not other._graphed()
            with Trainer.eager_steps():
                assert not tr._graphed()
            # the inner block's end leaves the outer one eager
            assert not tr._graphed()
            if exit_by == "raise":
                raise RuntimeError
    assert tr._graphed() and other._graphed()
    # the class keeps its capability; the block set nothing on it
    assert Trainer.supports_graphs and "supports_graphs" not in vars(tr)


class _CudaLike:
    """What ``device_span`` reads of a CUDA tensor."""

    is_cuda = True
    device = torch.device("cuda", 0)


@pytest.mark.parametrize("capturing", [True, False])
def test_device_span_records_nothing_while_capturing(capturing,
                                                     monkeypatch):
    rec = spans.Recorder()
    rec.enable(True, device=True)
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing",
                        lambda: capturing)
    cm = rec.device_span("dev.vq", _CudaLike())
    assert (cm is spans.OFF) == capturing
    # host spans are recorded either way
    assert rec.span("step.forward") is not spans.OFF
