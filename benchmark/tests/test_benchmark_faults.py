"""A run with the timed path broken underneath comes out not correct:
once for each fault the cells can have. The runs skip the look for a
card and drive the rest of a run on the CPU at a tiny size; a sound run
of each kind comes out correct."""

import pytest
from gaussian_splatting_web_tpu_torch.ops import rasterize
from gaussian_splatting_web_tpu_torch.train import train_loop

from conftest import run_tiny


def test_sound_runs_are_correct():
    assert run_tiny("tandt.view")["correct"] is True
    assert run_tiny("tandt.train")["correct"] is True


def test_a_step_that_leaves_its_state_unchanged(monkeypatch):
    monkeypatch.setattr(train_loop, "apply_gradients", lambda state: None)
    res = run_tiny("tandt.train")
    assert res["correct"] is False
    assert res["checks"]["change_norm_gap"]["value"] == 1.0


def test_half_the_batch_left_out(monkeypatch):
    loss = train_loop.photometric_loss

    def half(img, target, *args):
        h = img.shape[0] // 2
        return loss(img[:h], target[:h], *args)

    monkeypatch.setattr(train_loop, "photometric_loss", half)
    assert run_tiny("mipnerf360.train")["correct"] is False


def test_an_answer_altered_where_it_is_produced(monkeypatch):
    render = rasterize.render

    def altered(*args, **kwargs):
        img, aux = render(*args, **kwargs)
        img = img.clone()
        img[:16, :16] += 0.1          # one tile of every frame
        return img, aux

    monkeypatch.setattr(rasterize, "render", altered)
    assert run_tiny("tandt.view")["correct"] is False


def test_a_frame_that_raises_ends_the_run(monkeypatch):
    render = rasterize.render
    calls = []

    def failing(*args, **kwargs):
        calls.append(1)
        if len(calls) > 3:     # past the warm-up of the 2 test views
            raise RuntimeError("a failed launch")
        return render(*args, **kwargs)

    monkeypatch.setattr(rasterize, "render", failing)
    with pytest.raises(RuntimeError, match="a failed launch"):
        run_tiny("tandt.view")


def test_a_frame_of_the_wrong_view(monkeypatch):
    render = rasterize.render

    def shifted(cloud, camera, *args, **kwargs):
        cam = type(camera)(**{k: v.clone() for k, v in
                              vars(camera).items()})
        cam.view[0, 3] += 0.05
        return render(cloud, cam, *args, **kwargs)

    monkeypatch.setattr(rasterize, "render", shifted)
    assert run_tiny("mipnerf360.view")["correct"] is False


def test_no_exchange_between_chips_to_leave_out():
    # every cell runs on one chip, so the fault of a missing exchange
    # cannot occur; the benchmark asks for no more than it has
    import json
    from pathlib import Path

    spec = json.loads((Path(__file__).resolve().parents[2]
                       / "BENCHMARK.json").read_text())
    assert all(w["chips"] == 1 for w in spec["workloads"])
