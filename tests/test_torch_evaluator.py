"""The port's evaluator (dodt_tpu_torch.runtime.evaluator) against the
JAX one on a synthetic tracking fixture, with the same checkpointed
parameters (converted): the same detections per couple and frame, and
the same AP and MOT results when the JAX evaluator's run_checkpoint_once
scores the port's predictions in place of its own.

Tolerances: boxes 1e-4 (metres), scores and correlation offsets 1e-5
(f32 summation-order rounding); detection counts, classes and the
scorers' results are equal.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from dodt_tpu import config as cfg_mod
from dodt_tpu.data import synthetic, tracking
from dodt_tpu.models import dt_avod as jdt
from dodt_tpu.runtime.evaluator import Evaluator as JaxEvaluator
from dodt_tpu.runtime.trainer import CheckpointIO, create_train_state
from dodt_tpu_torch.convert import config_from_json, flax_to_state_dict
from dodt_tpu_torch.models import dt_avod as tdt
from dodt_tpu_torch.runtime.evaluator import Evaluator

CLUSTERS = ((3.9, 1.6, 1.52),)


@pytest.fixture(scope="module")
def evaluators(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("eval_torch")
    root = str(tmp / "kitti")
    synthetic.write_tracking_fixture(root, num_videos=1, num_frames=5,
                                     ego_speed=0.5)
    cfg = cfg_mod.unittest_pipeline()
    cfg.dataset.dataset_dir = root
    cfg.dataset.video_train_ids = (0,)
    cfg.dataset.max_points = 4096
    cfg.eval.batch_size = 3           # 4 couples: the last chunk is padded
    # random weights score about 0.5: let every detection start and keep
    # a track, so the MOT scorer sees the port's boxes
    cfg.eval.track_lth = cfg.eval.track_hth = 0.0
    cfg.eval.track_tmin = 1
    ds = tracking.KittiTrackingDataset(cfg.dataset, split="trainval")
    jmodel = jdt.DtAvodNet(cfg=cfg, cluster_sizes=CLUSTERS)
    batch = {k: jnp.asarray(v)[None]
             for k, v in ds.load_couple(0, augs=()).items()
             if isinstance(v, np.ndarray)}
    state = create_train_state(cfg, jmodel, batch, jax.random.PRNGKey(0))
    CheckpointIO(str(tmp / "ckpt")).save(1, state._replace(step=np.int32(1)))
    jev = JaxEvaluator(cfg, jmodel, ds, ckpt_dir=str(tmp / "ckpt"),
                       output_dir=str(tmp / "eval_jax"))
    params = jax.tree_util.tree_map(np.asarray, jev.ckpt.restore_params(1))
    tcfg = config_from_json(cfg)
    tmodel = tdt.DtAvodNet(tcfg, CLUSTERS)
    tmodel.load_state_dict(flax_to_state_dict(params), strict=True)
    return cfg, ds, jev, params, Evaluator(tcfg, tmodel.eval(), ds), tmp


@pytest.mark.parametrize("idxs", [[0, 1, 2], [3]], ids=["full", "padded"])
def test_predict_couples_match_jax(evaluators, idxs):
    _, ds, jev, params, ev, _ = evaluators
    want = jev.predict_couples(params, idxs)
    got = ev.predict_couples(idxs)
    assert len(got) == len(want) == len(idxs)
    n_dets = 0
    for g, w, idx in zip(got, want, idxs):
        assert g["couple"] == w["couple"] == ds.couples[idx]
        assert len(g["dets"]) == len(w["dets"]) == 2
        for gf, wf in zip(g["dets"], w["dets"]):
            assert len(gf) == len(wf)
            n_dets += len(gf)
            for gd, wd in zip(gf, wf):
                assert gd["class_idx"] == wd["class_idx"]
                np.testing.assert_allclose(gd["box_3d"], wd["box_3d"],
                                           atol=1e-4)
                np.testing.assert_allclose(gd["score"], wd["score"],
                                           atol=1e-5)
                if wd["offsets"] is None:
                    assert gd["offsets"] is None
                else:
                    np.testing.assert_allclose(gd["offsets"], wd["offsets"],
                                               atol=1e-5)
    assert n_dets > 0


def test_predict_couple_is_the_first_of_a_batch(evaluators):
    _, _, _, _, ev, _ = evaluators
    one, = ev.predict_couples([2])
    again = ev.predict_couple(2)
    assert one["couple"] == again["couple"]
    for a, b in zip(one["dets"], again["dets"]):
        assert [d["score"] for d in a] == [d["score"] for d in b]


def test_scores_match_jax_with_port_predictions(evaluators, monkeypatch):
    """run_checkpoint_once's AP (both IoU passes, every class, metric and
    difficulty) and MOT results are the same whether the JAX evaluator
    scores its own predictions or the port's."""
    cfg, ds, jev, _, ev, tmp = evaluators
    want = jev.run_checkpoint_once(1)
    port = JaxEvaluator(cfg, jev.model, ds, ckpt_dir=str(tmp / "ckpt"),
                        output_dir=str(tmp / "eval_port"))
    monkeypatch.setattr(port, "predict_couples",
                        lambda params, idxs: ev.predict_couples(idxs))
    got = port.run_checkpoint_once(1)
    for key in ("ap_per_class", "ap_05_per_class"):
        for cls, metrics in want[key].items():
            for metric, by_diff in metrics.items():
                for diff, v in by_diff.items():
                    np.testing.assert_allclose(
                        got[key][cls][metric][diff], v, atol=1e-6,
                        err_msg=f"{key}/{cls}/{metric}/{diff}")
    assert got["mot"].keys() == want["mot"].keys()
    for vid, res in want["mot"].items():
        for k, v in res.items():
            if isinstance(v, (int, float)):
                np.testing.assert_allclose(got["mot"][vid][k], v, atol=1e-6,
                                           err_msg=f"mot/{vid}/{k}")
    assert want["mot"]["overall"]["TP"] + want["mot"]["overall"]["FP"] > 0
