"""One-shot serving of the port (``mxnet_tpu_torch/serving``: bucket
padding, the flush micro-batcher, ``freeze`` -> ``FrozenProgram``,
``InferenceSession.submit`` / ``infer``), mirroring the JAX package's
tests in ``tests/test_serving.py`` that apply to it (:73, :113-250,
:272, :293, :309, :318, :328, :397, :495, :500), and the SSD detector
served through it.

The batcher tests are the JAX ones with the port's classes; the freeze
and session tests use a small gluon net of the port in place of the JAX
tests' fitted ``Module`` (the symbolic API is not ported: freezing
anything but a Block raises ``TypeError``). Everything runs on the CPU:
the kernels' plain versions.
"""
import threading
import time
from concurrent.futures import Future

import numpy as np
import pytest
import torch

from mxnet_tpu_torch import serving
from mxnet_tpu_torch.gluon import Block
from mxnet_tpu_torch.gluon import nn
from mxnet_tpu_torch.gluon.model_zoo import ssd
from mxnet_tpu_torch.ops import kernels
from mxnet_tpu_torch.serving.batcher import (BackpressureError, BatcherClosed,
                                             MicroBatcher, RequestTimeout,
                                             _Request)
from mxnet_tpu_torch.serving.bucket import BucketPolicy, pad_axis0, \
    unpad_axis0

torch.set_num_threads(1)


def _mlp(features=8, classes=4):
    """A Dense(16, relu) -> Dense(classes) net from a numpy seed."""
    net = nn.HybridSequential()
    net.add(nn.Dense(16, activation='relu', in_units=features,
                     device='cpu'),
            nn.Dense(classes, in_units=16, device='cpu'))
    rs = np.random.RandomState(0)
    with torch.no_grad():
        for p in net.parameters():
            p.copy_(torch.from_numpy(rs.randn(*p.shape).astype('float32')))
    return net


def _x(n=32, features=8):
    return np.random.RandomState(1).randn(n, features).astype('float32')


# -- bucket math --------------------------------------------------------------

def test_pad_unpad_round_trip_bit_exact():
    rs = np.random.RandomState(3)
    x = rs.randn(5, 7).astype('float32')
    padded = pad_axis0(x, 8)
    assert padded.shape == (8, 7)
    assert np.array_equal(padded[5:], np.zeros((3, 7), 'float32'))
    assert np.array_equal(unpad_axis0(padded, 5), x)
    assert pad_axis0(x, 5) is x      # no copy when already at bucket
    with pytest.raises(ValueError):
        pad_axis0(x, 4)
    out, n = BucketPolicy(buckets=(2, 8)).pad([x, x[:, :3]])
    assert n == 5 and [a.shape for a in out] == [(8, 7), (8, 3)]


# -- micro-batcher contract ---------------------------------------------------

def _echo_runner(calls=None):
    def runner(stacked, n):
        if calls is not None:
            calls.append(n)
        return [stacked[0] * 2.0]
    return runner


def test_batcher_max_batch_flush():
    calls = []
    with MicroBatcher(_echo_runner(calls), max_batch=4,
                      deadline_ms=60000.0, timeout_s=30.0) as b:
        futs = [b.submit(np.full(2, i, 'float32')) for i in range(4)]
        outs = [f.result(10)[0] for f in futs]
    assert 4 in calls, calls    # one aggregated batch, not 4 singles
    assert b.stats()['flushes']['full'] >= 1
    for i, out in enumerate(outs):
        assert np.array_equal(out, np.full(2, 2.0 * i))


def test_batcher_deadline_flush():
    with MicroBatcher(_echo_runner(), max_batch=1024, deadline_ms=5.0,
                      timeout_s=30.0) as b:
        out = b.infer(np.ones(3, 'float32'))[0]
        assert np.array_equal(out, 2.0 * np.ones(3))
    assert b.stats()['flushes']['deadline'] >= 1
    assert b.stats()['flushes']['full'] == 0


def test_batcher_fifo_under_concurrent_submitters():
    results = {}
    with MicroBatcher(_echo_runner(), max_batch=8, deadline_ms=5.0,
                      timeout_s=30.0) as b:
        def client(i):
            results[i] = b.infer(np.full(3, i, 'float32'))[0]
        threads = [threading.Thread(target=client, args=(i,))
                   for i in range(24)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(30)
    for i in range(24):
        assert np.array_equal(results[i], np.full(3, 2.0 * i)), \
            'request %d got another request\'s row' % i


def test_batcher_queue_full_rejection_typed_and_immediate():
    gate = threading.Event()

    def blocked(stacked, n):
        gate.wait(30)
        return [stacked[0]]

    b = MicroBatcher(blocked, max_batch=1, deadline_ms=0.0,
                     max_queue=2, timeout_s=30.0)
    try:
        b.submit(np.zeros(2))
        deadline = time.monotonic() + 5.0
        while b.stats()['depth'] and time.monotonic() < deadline:
            time.sleep(0.002)   # worker holds request 0 in the runner
        b.submit(np.zeros(2))
        b.submit(np.zeros(2))
        t0 = time.monotonic()
        with pytest.raises(BackpressureError) as exc:
            b.submit(np.zeros(2))
        assert time.monotonic() - t0 < 1.0, 'rejection must not block'
        assert exc.value.limit == 2 and exc.value.depth == 2
        assert b.stats()['rejected'] == 1
        assert b.retry_after_hint() >= 0.05
    finally:
        gate.set()
        b.close(drain=False)


def test_batcher_per_request_timeout_while_worker_stuck():
    gate = threading.Event()

    def blocked(stacked, n):
        gate.wait(30)
        return [stacked[0]]

    b = MicroBatcher(blocked, max_batch=1, deadline_ms=0.0,
                     max_queue=8, timeout_s=0.2)
    try:
        inflight = b.submit(np.zeros(2))    # occupies the worker
        fut = b.submit(np.zeros(2))         # ages out in the queue
        with pytest.raises(RequestTimeout):
            fut.result(10)
        # the in-flight request honours the budget too
        with pytest.raises(RequestTimeout):
            inflight.result(10)
        assert b.stats()['timeouts'] >= 2
    finally:
        gate.set()
        b.close(drain=False)


def test_batcher_flush_drops_expired_and_cancelled_requests():
    """Requests expired by the reaper (or cancelled) between the batch pop
    and the flush consume no device rows; the live ones keep their FIFO
    row mapping."""
    now = [100.0]
    calls = []

    def runner(stacked, n):
        calls.append(n)
        return [stacked[0] * 2.0]

    b = MicroBatcher(runner, max_batch=8, deadline_ms=1e9, max_queue=8,
                     timeout_s=1.0, name='flush-expire',
                     clock=lambda: now[0])
    try:
        live = _Request([np.ones(3, 'float32')], Future(), 99.5, 101.0)
        expired = _Request([np.full(3, 7.0, 'float32')], Future(),
                           98.0, 99.0)
        cancelled = _Request([np.full(3, 9.0, 'float32')], Future(),
                             99.5, 101.0)
        cancelled.future.cancel()
        batch = [expired, live, cancelled]
        with b._lock:
            b._inflight = batch
        b._run_batch(batch, 'full')
        assert calls == [1]
        assert np.array_equal(live.future.result(0)[0],
                              np.full(3, 2.0, 'float32'))
        with pytest.raises(RequestTimeout):
            expired.future.result(0)
        gone = _Request([np.ones(3, 'float32')], Future(), 90.0, 91.0)
        with b._lock:
            b._inflight = [gone]
        b._run_batch([gone], 'full')
        assert calls == [1]            # an all-dead batch skips the device
        with pytest.raises(RequestTimeout):
            gone.future.result(0)
    finally:
        b.close(drain=False)


def test_batcher_sheds_doomed_requests_at_dequeue():
    """A request whose budget cannot outlast a batch of recent latency
    fails at dequeue, typed, instead of running late."""
    now = [0.0]
    b = MicroBatcher(_echo_runner(), max_batch=4, deadline_ms=1e9,
                     max_queue=8, timeout_s=1.0, clock=lambda: now[0])
    try:
        b._ema_batch_s = 0.5
        doomed = _Request([np.ones(2)], Future(), 0.0, 0.6)
        fine = _Request([np.ones(2)], Future(), 0.0, 2.0)
        now[0] = 0.3
        fails = []
        with b._lock:
            kept = b._shed_doomed_locked([doomed, fine], now[0], fails)
        b._fail_expired(fails)
        assert kept == [fine]
        with pytest.raises(RequestTimeout):
            doomed.future.result(0)
        assert b.stats()['shed_doomed'] == 1
    finally:
        b.close(drain=False)


def test_batcher_example_shape_validation():
    got = []

    def runner(stacked, n):
        got.append(stacked[0].shape)
        return [stacked[0]]

    with MicroBatcher(runner, max_batch=1, deadline_ms=0.0,
                      timeout_s=10.0, example_shapes=[(1, 4, 4)]) as b:
        # a genuine rank-3 example whose first dim is 1 is not a batch
        b.infer(np.zeros((1, 4, 4), 'float32'))
        # an explicit batch axis of 1 is stripped by rank
        b.infer(np.zeros((1, 1, 4, 4), 'float32'))
        with pytest.raises(ValueError):
            b.submit(np.zeros((4, 4), 'float32'))
        with pytest.raises(ValueError):
            b.submit(np.zeros(3), np.zeros(3))   # wrong input arity
    assert got == [(1, 1, 4, 4), (1, 1, 4, 4)]


def test_batcher_runner_error_propagates_and_closed_rejects():
    def boom(stacked, n):
        raise ValueError('deterministic bug')

    b = MicroBatcher(boom, max_batch=1, deadline_ms=0.0, timeout_s=5.0)
    with pytest.raises(ValueError):
        b.infer(np.zeros(2))
    b.close()
    with pytest.raises(BatcherClosed):
        b.submit(np.zeros(2))


# -- freeze -------------------------------------------------------------------

def test_freeze_batched_bit_identical_to_single_at_its_bucket():
    """Each row of a batch equals the same example run alone in a batch of
    that bucket (zero rows beside it): no row sees another."""
    frozen = serving.freeze(_mlp(), data_shapes=[('data', (8,))],
                            max_batch=8)
    x = _x()
    got = frozen.run([x[:5]])[0]
    assert got.shape == (5, 4)
    for i in range(5):
        ref = frozen.run([pad_axis0(x[i:i + 1], 8)], n=8)[0][0]
        assert np.array_equal(got[i], ref)


def test_freeze_recompile_bounded_by_buckets():
    frozen = serving.freeze(_mlp(), data_shapes=[('data', (8,))],
                            max_batch=8)
    x = _x()
    for n in (1, 3, 8, 2, 5, 8, 1, 7):
        frozen.run([x[:n]])
    assert frozen.compile_count == 4      # ladder 1, 2, 4, 8
    assert frozen.warmup().compile_count == 4


def test_freeze_oversized_bulk_batch_chunks():
    frozen = serving.freeze(_mlp(), data_shapes=[('data', (8,))],
                            max_batch=4)
    x = _x(11)
    got = frozen.run([x])[0]
    assert got.shape[0] == 11
    ref = np.concatenate([frozen.run([x[i:i + 4]])[0]
                          for i in range(0, 11, 4)])
    assert np.array_equal(got, ref)


def test_freeze_gluon_block_matches_direct_call():
    net = _mlp()
    x = _x(6)
    with torch.no_grad():
        ref = net(torch.from_numpy(x)).numpy()
    frozen = serving.freeze(net, data_shapes=[('data', (8,))], max_batch=8)
    assert frozen.data_descs == [('data', (8,), 'float32')]
    np.testing.assert_allclose(frozen.run([x])[0], ref, rtol=1e-6,
                               atol=1e-6)


def test_freeze_rejects_the_symbolic_api():
    for obj in ((object(), {}, {}), object()):
        with pytest.raises(TypeError, match='symbolic API'):
            serving.freeze(obj, data_shapes=[('data', (8,))])


# -- InferenceSession ---------------------------------------------------------

def test_session_concurrent_requests_bit_identical():
    frozen = serving.freeze(_mlp(), data_shapes=[('data', (8,))],
                            buckets=(8,))
    x = _x()
    refs = frozen.run([x[:10]])[0]
    with serving.InferenceSession(frozen, deadline_ms=10.0) as sess:
        futs = [sess.submit(x[i]) for i in range(10)]
        for i, f in enumerate(futs):
            assert np.array_equal(f.result(30)[0], refs[i])
        st = sess.stats()
    assert st['queue']['completed'] == 10
    assert sum(st['batches_by_bucket'].values()) == st['queue']['batches']


def test_session_rank3_single_example_round_trip():
    """A conv-style (c, h, w) example with a leading dim of 1 served
    through the session."""
    net = nn.HybridSequential()
    net.add(nn.Flatten(), nn.Dense(4, in_units=16, device='cpu'))
    with torch.no_grad():
        list(net.children())[1].weight.copy_(torch.from_numpy(
            np.random.RandomState(0).randn(4, 16).astype('float32')))
    x = np.random.RandomState(0).randn(8, 1, 4, 4).astype('float32')
    frozen = serving.freeze(net, data_shapes=[('data', (1, 4, 4))],
                            max_batch=4)
    ref = frozen.run([x[:1]])[0][0]
    with serving.InferenceSession(frozen, deadline_ms=1.0) as sess:
        out = sess.infer(x[0], timeout=30)[0]       # (1, 4, 4) example
        assert np.array_equal(out, ref)
        np.testing.assert_array_equal(sess.infer_batch([x[:3]])[0],
                                      frozen.run([x[:3]])[0])


def test_session_rejects_non_frozen():
    with pytest.raises(TypeError):
        serving.InferenceSession(object())
    frozen = serving.freeze(_mlp(), data_shapes=[('data', (8,))],
                            max_batch=4)
    with pytest.raises(ValueError):
        serving.InferenceSession(frozen, max_batch=8)   # above the ladder
    with serving.InferenceSession(frozen) as sess:
        with pytest.raises(TypeError):
            sess.generate([1, 2, 3])


def test_serving_knob_defaults_flow_from_config(monkeypatch):
    monkeypatch.setenv('MXNET_TPU_SERVE_QUEUE_DEPTH', '7')
    monkeypatch.setenv('MXNET_TPU_SERVE_DEADLINE_MS', '2.5')
    monkeypatch.setenv('MXNET_TPU_SERVE_BUCKETS', '1,3,6')
    frozen = serving.freeze(_mlp(), data_shapes=[('data', (8,))])
    assert frozen.policy.buckets == (1, 3, 6)
    sess = serving.InferenceSession(frozen)
    try:
        assert sess._batcher.max_queue == 7
        assert sess._batcher.deadline_s == 0.0025
        assert sess._batcher.max_batch == 6
    finally:
        sess.close()
    monkeypatch.delenv('MXNET_TPU_SERVE_BUCKETS')
    monkeypatch.setenv('MXNET_TPU_SERVE_MAX_BATCH', '4')
    assert serving.freeze(_mlp(), data_shapes=[('data', (8,))]) \
        .policy.buckets == (1, 2, 4)


# -- the SSD detector, served -------------------------------------------------

class _Detector(Block):
    """SSD then MultiBoxDetection: one image in, (N, 6) detections out."""

    def __init__(self, net):
        super().__init__()
        self.net = net
        self.det = ssd.MultiBoxDetection()

    def forward(self, x):
        return self.det(*self.net(x))


def test_ssd_served_batched_equals_direct_run_at_its_bucket():
    """The tiny SSD of ``tests/test_image_ssd.py`` behind the session:
    every response equals, bitwise, the direct run of its image in a batch
    of the bucket its batch ran in."""
    net = ssd.SSD(3, sizes=[(0.2, 0.3), (0.5, 0.6)],
                  ratios=[(1.0, 2.0, 0.5)] * 2, base_channels=(8, 16),
                  scale_channels=(16,), device='cpu')
    ssd.init_params(net, seed=0)
    frozen = serving.freeze(_Detector(net),
                            data_shapes=[('data', (3, 32, 32))],
                            buckets=(1, 2, 4, 8))
    frozen.warmup()
    assert frozen.compile_count == 4
    x = np.random.RandomState(0).uniform(-1, 1, (12, 3, 32, 32)) \
        .astype('float32')
    seen = []
    run = frozen.run

    def recording(arrays, n=None):
        seen.append((arrays[0].copy(), frozen.policy.bucket_for(n)))
        return run(arrays, n)

    frozen.run = recording
    kernels.reset_launch_counts()
    with serving.InferenceSession(frozen, max_batch=8,
                                  deadline_ms=5.0) as sess:
        futs = [sess.submit(x[i]) for i in range(12)]
        outs = [f.result(60)[0] for f in futs]
        st = sess.stats()
    del frozen.run
    assert not any(kernels.launch_counts().values())
    assert st['queue']['completed'] == 12
    assert sum(st['batches_by_bucket'].values()) == len(seen)
    for i, out in enumerate(outs):
        assert out.shape == (320, 6) and np.isfinite(out).all()
        assert (out[:, 0] >= 0).any()
        bucket = next(b for rows, b in seen
                      if any(np.array_equal(r, x[i]) for r in rows))
        ref = frozen.run([pad_axis0(x[i:i + 1], bucket)], n=bucket)[0][0]
        assert np.array_equal(out, ref), 'request %d' % i
