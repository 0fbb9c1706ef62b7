"""The port's online mapper on the CPU: tests/test_mapper.py's six tests on
the port's Mapper, Trainer, producers and protocol; the loop's pop, which
waits only after a pass that did not train; and a parity test that feeds one
synchronous operation stream (keyframes, pose updates, a loop closure and a
scale refinement) into the JAX Mapper and the port's.

Parity tolerances: keyframe poses, times of use and the sampler's counts
equal (they are set from the stream, not computed); per-iteration losses
within rtol 1e-4 (tests/test_torch_trainer.py's Trainer tolerance); anchors
and decoder weights within 1e-5 after the run (f32 rounding of the same
Adam updates). Densification stays out of the run: its keep-masks are
random draws that differ between the packages.
"""

import threading

import jax
import numpy as np

from segs_slam_tpu.core.camera import Camera as JCamera
from segs_slam_tpu.core.keyframe import Keyframe as JKeyframe
from segs_slam_tpu.models.config import ModelConfig as JModelConfig
from segs_slam_tpu.models.decoders import init_decoders
from segs_slam_tpu.ops.rasterizer import RasterConfig as JRasterConfig
from segs_slam_tpu.slam.mapper import Mapper as JMapper
from segs_slam_tpu.slam.mapper import MapperConfig as JMapperConfig
from segs_slam_tpu.slam.producers import (
    SyntheticOracleProducer as JSyntheticOracleProducer,
)
from segs_slam_tpu.slam import protocol as jprotocol
from segs_slam_tpu.train.config import OptimizationConfig as JOptConfig
from segs_slam_tpu.train.trainer import Trainer as JTrainer
from segs_slam_tpu_torch.core import Camera, Keyframe
from segs_slam_tpu_torch.io.convert import (
    decoders_from_jax,
    flatten_params,
    train_state_to_numpy,
)
from segs_slam_tpu_torch.models.config import ModelConfig
from segs_slam_tpu_torch.ops.rasterizer import RasterConfig
from segs_slam_tpu_torch.slam.mapper import Mapper, MapperConfig
from segs_slam_tpu_torch.slam.producers import (
    SyntheticOracleProducer,
    tracker_pose_updates,
)
from segs_slam_tpu_torch.slam.protocol import (
    MappingOperation,
    MappingQueue,
    OperationKind,
    record_stream,
    replay_stream,
)
from segs_slam_tpu_torch.train.config import OptimizationConfig
from segs_slam_tpu_torch.train.trainer import Trainer
from test_torch_core import two_torch_threads  # noqa: F401 (autouse)

W = H = 32
MODEL = dict(feat_dim=8, n_offsets=4, appearance_dim=8, embedding_dim=4,
             capacity=128, voxel_size=0.05)
OPT = dict(use_frequency_regularization=False, start_stat=2, update_from=5,
           update_interval=10, update_until=100)
RASTER = dict(tile=16, compact=256, kmax=16, chunk=64)


def _make_setup(classes=(Camera, Keyframe, ModelConfig, OptimizationConfig,
                         RasterConfig, Trainer), opt=OPT, **trainer_kw):
    """tests/test_mapper.py's setup on the given package's classes."""
    cam_cls, kf_cls, mc_cls, oc_cls, rc_cls, trainer_cls = classes
    cam = cam_cls(camera_id=0, width=W, height=H, fx=28.0, fy=28.0,
                  cx=W / 2, cy=H / 2)
    rng = np.random.default_rng(0)
    kfs = []
    for i in range(6):
        img = rng.uniform(0.1, 0.9, (3, H, W)).astype(np.float32)
        kfs.append(kf_cls(kf_id=i, camera=cam, quat=[1, 0, 0, 0],
                          trans=[0.05 * i, 0, 0], image=img))
    trainer = trainer_cls(mc_cls(**MODEL), oc_cls(**opt), rc_cls(**RASTER),
                          width=W, height=H, **trainer_kw)
    trainer.scene.add_camera(cam)
    return cam, kfs, trainer


def _port_setup():
    return _make_setup(device="cpu")


def _sparse_fn(rng):
    def fn(kf):
        return rng.uniform([-0.6, -0.5, 1.2], [0.6, 0.5, 3.0], (60, 3))
    return fn


def test_mapper_end_to_end():
    cam, kfs, trainer = _port_setup()
    queue = MappingQueue()
    producer = SyntheticOracleProducer(
        kfs, cam, queue, sparse_points_fn=_sparse_fn(np.random.default_rng(1)))
    mapper = Mapper(queue, trainer, cam,
                    MapperConfig(min_num_initial_map_kfs=3))
    producer.run()  # fill the queue synchronously
    mapper.run(max_iterations=12)
    assert mapper.initialized
    assert trainer.iteration == 12
    assert len(trainer.scene.keyframes) == 6
    assert int(trainer.state.anchors.num_active()) > 0


def test_mapper_pose_update_and_loop_closure():
    cam, kfs, trainer = _port_setup()
    queue = MappingQueue()
    SyntheticOracleProducer(
        kfs, cam, queue,
        sparse_points_fn=_sparse_fn(np.random.default_rng(2))).run()
    mapper = Mapper(queue, trainer, cam,
                    MapperConfig(min_num_initial_map_kfs=2))
    mapper.run(max_iterations=4)
    q = np.array([0.9, 0.1, 0.0, 0.0])
    new_pose = (q / np.linalg.norm(q), np.array([0.3, 0.1, -0.2]))
    queue.push(MappingOperation(kind=OperationKind.LOOP_CLOSING_BA,
                                pose_updates={2: new_pose}))
    mapper.run(max_iterations=6)
    np.testing.assert_allclose(trainer.scene.keyframes[2].trans, new_pose[1])
    assert mapper.loop_closure_iteration


def test_mapper_scale_refinement():
    cam, kfs, trainer = _port_setup()
    queue = MappingQueue()
    SyntheticOracleProducer(
        kfs, cam, queue,
        sparse_points_fn=_sparse_fn(np.random.default_rng(3))).run()
    mapper = Mapper(queue, trainer, cam,
                    MapperConfig(min_num_initial_map_kfs=2))
    mapper.run(max_iterations=3)
    a_before = trainer.state.anchors.anchor.clone()
    n_act = int(trainer.state.anchors.num_active())
    queue.push(MappingOperation(kind=OperationKind.SCALE_REFINEMENT,
                                scale=2.0, transform=np.eye(4)))
    # drain any remaining producer ops plus the scale op
    mapper.run(max_iterations=3 + queue._q.qsize() + 1)
    np.testing.assert_allclose(
        trainer.state.anchors.anchor[:n_act].numpy(),
        a_before[:n_act].numpy() * 2.0, rtol=1e-4)


def test_record_replay_stream(tmp_path):
    cam, kfs, _ = _port_setup()
    queue = MappingQueue()
    SyntheticOracleProducer(
        kfs, cam, queue,
        sparse_points_fn=_sparse_fn(np.random.default_rng(4))).run()
    ops = queue.drain()
    path = tmp_path / "stream.pkl"
    record_stream(ops, path)
    replayed = list(replay_stream(path))
    assert len(replayed) == len(ops)
    assert replayed[0].kind == OperationKind.LOCAL_MAPPING_BA
    np.testing.assert_allclose(replayed[0].keyframes[0].image,
                               ops[0].keyframes[0].image)


def test_tracker_pose_updates_mapping():
    """Native frame ordinals map to dataset frame ids; out-of-range ordinals
    are dropped (producers.tracker_pose_updates)."""
    fed = [3, 7, 11]  # dataset frame ids in feed order
    poses = np.arange(3 * 7, dtype=float).reshape(3, 7)
    upd = tracker_pose_updates(fed, [0, 2, 5], poses)
    assert set(upd) == {3, 11}  # ordinal 5 out of range -> dropped
    q, t = upd[11]
    np.testing.assert_allclose(t, poses[1, 0:3])
    np.testing.assert_allclose(q, poses[1, 3:7])


def test_pose_refine_on_arrival_runs_before_training():
    """MapperConfig.pose_refine_on_arrival: each post-initialization
    keyframe gets frame-to-model alignment before add_keyframe."""
    cam, kfs, trainer = _port_setup()
    queue = MappingQueue()
    producer = SyntheticOracleProducer(
        kfs, cam, queue, sparse_points_fn=_sparse_fn(np.random.default_rng(1)))
    refined = []
    orig = trainer.refine_keyframe_pose

    def spy(kf, steps=5, lr=4e-3):
        refined.append((kf.kf_id, steps))
        assert kf.kf_id not in trainer.scene.keyframes  # before add
        return orig(kf, steps=steps, lr=lr)

    trainer.refine_keyframe_pose = spy
    mapper = Mapper(queue, trainer, cam,
                    MapperConfig(min_num_initial_map_kfs=3,
                                 pose_refine_on_arrival=2))
    producer.run()
    mapper.run(max_iterations=10)
    assert mapper.initialized
    # keyframes 0-2 initialize the map (no refinement possible); 3-5 arrive
    # after initialization and must each have been aligned with the
    # configured step count
    assert [r[0] for r in refined] == [3, 4, 5]
    assert all(steps == 2 for _, steps in refined)


def test_pop_waits_only_after_a_pass_that_did_not_train():
    """Mapper.run's first pass waits up to 10 ms on the queue; a pass after
    one that trained takes only what is there. Operations pushed before the
    call and from another thread during it are applied in push order, one a
    pass, the first two at the passes where a waiting pop applied them, and
    every pass still trains one iteration."""
    cam, kfs, trainer = _port_setup()
    queue = MappingQueue()
    SyntheticOracleProducer(
        kfs, cam, queue,
        sparse_points_fn=_sparse_fn(np.random.default_rng(7))).run()
    mapper = Mapper(queue, trainer, cam,
                    MapperConfig(min_num_initial_map_kfs=3))
    mapper.run(max_iterations=3)  # three operations initialise, three train
    assert mapper.initialized and not queue.has_operation()
    timeouts, applied = [], []
    pop, apply = queue.pop, mapper._apply_operation

    def recording_pop(timeout=None):
        timeouts.append(timeout)
        return pop(timeout=timeout)

    def recording_apply(op):
        applied.append((op, len(timeouts)))
        apply(op)

    queue.pop = recording_pop
    mapper._apply_operation = recording_apply
    mapper.run(max_iterations=11)
    assert trainer.iteration == 11 and not applied
    assert timeouts == [0.01] + [0.0] * 7

    ops = [MappingOperation(kind=OperationKind.LOCAL_MAPPING_BA,
                            pose_updates={k: (np.array([1.0, 0, 0, 0]),
                                              np.array([0.05 * k, 0.01, 0]))})
           for k in (1, 2, 3)]
    queue.push(ops[0])
    queue.push(ops[1])
    timeouts.clear()
    iterate = trainer.train_iteration
    trained = []
    late = threading.Timer(0.0, queue.push, args=(ops[2],))

    def train_iteration():
        m = iterate()
        trained.append(m is not None)
        if len(trained) == 3:
            late.start()  # partway through the call
        if len(applied) == 3:
            mapper.abort()
        return m

    trainer.train_iteration = train_iteration
    mapper.run(max_iterations=211)  # the bound only guards a lost push
    late.join(timeout=10)
    assert [op for op, _ in applied] == ops
    assert [at for _, at in applied[:2]] == [1, 2]
    assert applied[2][1] > 3
    assert all(trained) and len(trained) == len(timeouts)
    assert trainer.iteration == 11 + len(trained)
    assert timeouts == [0.01] + [0.0] * (len(timeouts) - 1)
    np.testing.assert_allclose(trainer.scene.keyframes[3].trans,
                               ops[2].pose_updates[3][1])


def _stream_ops(protocol, rng):
    """The extra operations of the parity stream, in the given package's
    protocol classes: a local-BA pose refresh, a loop closure and a scale
    refinement with a rigid correction and pose updates."""
    q = np.array([0.98, 0.02, -0.05, 0.01])
    q /= np.linalg.norm(q)
    R = np.array([[0.995, -0.0998, 0.0], [0.0998, 0.995, 0.0],
                  [0.0, 0.0, 1.0]])
    R, _ = np.linalg.qr(R)
    T = np.eye(4)
    T[:3, :3] = R
    T[:3, 3] = [0.02, -0.01, 0.03]
    kind = protocol.OperationKind
    return [
        protocol.MappingOperation(
            kind=kind.LOCAL_MAPPING_BA,
            pose_updates={1: (q, np.array([0.06, 0.01, -0.02]))}),
        protocol.MappingOperation(
            kind=kind.LOOP_CLOSING_BA,
            pose_updates={2: (np.array([1.0, 0.0, 0.0, 0.0]),
                              np.array([0.1, 0.0, 0.01]))}),
        protocol.MappingOperation(
            kind=kind.SCALE_REFINEMENT, scale=1.1, transform=T,
            pose_updates={0: (q, rng.normal(scale=0.05, size=3))}),
    ]


def test_mapper_matches_jax():
    """One op stream (SyntheticOracleProducer.run, then the extra ops) into
    the JAX Mapper and the port's, the port's map seeded with the JAX
    Trainer's initial decoders: per-iteration losses, keyframe poses, times
    of use, anchors and decoders."""
    jclasses = (JCamera, JKeyframe, JModelConfig, JOptConfig, JRasterConfig,
                JTrainer)
    opt = dict(OPT, update_from=1000, update_until=2000)
    runs = {}
    for name, classes, producer_cls, protocol, mapper_cls, cfg_cls, kw in (
            ("jax", jclasses, JSyntheticOracleProducer, jprotocol, JMapper,
             JMapperConfig, {"seed": 2}),
            ("port", None, SyntheticOracleProducer, None, Mapper,
             MapperConfig, {"seed": 2, "device": "cpu"})):
        import segs_slam_tpu_torch.slam.protocol as tprotocol

        protocol = protocol or tprotocol
        cam, kfs, trainer = _make_setup(
            classes or (Camera, Keyframe, ModelConfig, OptimizationConfig,
                        RasterConfig, Trainer), opt=opt, **kw)
        queue = protocol.MappingQueue()
        producer_cls(kfs, cam, queue, sparse_points_fn=_sparse_fn(
            np.random.default_rng(5))).run()
        for op in _stream_ops(protocol, np.random.default_rng(6)):
            queue.push(op)
        if name == "port":
            # the JAX Trainer's initial decoders (init_decoders from its
            # seed), as tests/test_torch_trainer.py carries them
            dec = decoders_from_jax(flatten_params(jax.tree.map(
                np.asarray, init_decoders(jax.random.PRNGKey(2),
                                          JModelConfig(**MODEL)))))
            init = trainer.initialize_map
            trainer.initialize_map = lambda pts: init(pts, decoders=dec)
        losses = []
        step = trainer.train_iteration

        def recording(step=step, losses=losses):
            m = step()
            if m is not None:
                losses.append(float(m["loss"]))
            return m

        trainer.train_iteration = recording
        mapper = mapper_cls(queue, trainer, cam,
                            cfg_cls(min_num_initial_map_kfs=3))
        mapper.run(max_iterations=10)
        runs[name] = (trainer, mapper, losses)

    (jt, jm, jl), (tt, tm, tl) = runs["jax"], runs["port"]
    assert jm.initialized and tm.initialized and jm.loop_closure_iteration
    assert len(tl) == len(jl) == 10
    np.testing.assert_allclose(tl, jl, rtol=1e-4)
    assert set(tt.scene.keyframes) == set(jt.scene.keyframes) == set(range(6))
    for kid, kf in tt.scene.keyframes.items():
        jkf = jt.scene.keyframes[kid]
        np.testing.assert_array_equal(kf.quat, np.asarray(jkf.quat))
        np.testing.assert_array_equal(kf.trans, np.asarray(jkf.trans))
        assert kf.remaining_times_of_use == jkf.remaining_times_of_use
    assert tt.scene.kfs_used_times == jt.scene.kfs_used_times
    ours = train_state_to_numpy(tt.state)
    ja = jax.tree.map(np.asarray, jt.state.anchors)._asdict()
    for name, ref in ja.items():
        np.testing.assert_allclose(ours["anchors"][name], ref, rtol=1e-5,
                                   atol=1e-5, err_msg=name)
    jd = flatten_params(jax.tree.map(np.asarray, jt.state.decoders))
    td = flatten_params(ours["decoders"])
    assert td.keys() == jd.keys()
    for name, ref in jd.items():
        np.testing.assert_allclose(td[name], ref, rtol=1e-5, atol=1e-5,
                                   err_msg=name)
