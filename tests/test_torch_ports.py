"""The port's ring-buffer ports and message words against the JAX
package's: the cases of tests/core/test_ports.py (FIFO order and capacity,
ready time, default peer) run through both packages and compared field by
field, plus the bitcasts on special bit patterns and ``oh_set`` with
out-of-range indices."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

try:                           # optional: only the property test needs it
    from hypothesis import given, settings
    from hypothesis import strategies as st
    HAVE_HYPOTHESIS = True
except ImportError:            # pragma: no cover
    HAVE_HYPOTHESIS = False

import repro.core.message as jmsg
import repro.core.ports as jports
import repro_torch.core.message as tmsg
import repro_torch.core.ports as tports
from _torch_sim_parity import assert_same_state, as_np


def _empty(P=1, CAP=4):
    """The same empty view in each package: (jax, torch)."""
    arrays = dict(
        in_buf=np.zeros((P, CAP, 8), np.int32),
        in_head=np.zeros((P,), np.int32), in_cnt=np.zeros((P,), np.int32),
        out_buf=np.zeros((P, CAP, 8), np.int32),
        out_head=np.zeros((P,), np.int32), out_cnt=np.zeros((P,), np.int32),
        cap=np.full((P,), CAP, np.int32), gid=np.arange(P, dtype=np.int32),
        peer=np.full((P,), -1, np.int32), t=np.float32(0.0))
    return _views(arrays)


def _views(arrays):
    j = jports.Ports(**{k: jnp.asarray(v) for k, v in arrays.items()})
    t = tports.Ports(**{k: torch.as_tensor(np.asarray(v))
                        for k, v in arrays.items()})
    return j, t


def _replace(views, **kw):
    j, t = views
    return (jports.Ports(**{**j.__dict__, **{k: jnp.asarray(v)
                                             for k, v in kw.items()}}),
            tports.Ports(**{**t.__dict__,
                            **{k: torch.as_tensor(np.asarray(v))
                               for k, v in kw.items()}}))


def test_message_words_match():
    assert tmsg.MSG_WORDS == jmsg.MSG_WORDS
    assert (tmsg.W_OP, tmsg.W_SRC, tmsg.W_DST, tmsg.W_TIME) == \
        (jmsg.W_OP, jmsg.W_SRC, jmsg.W_DST, jmsg.W_TIME)
    assert tports.EPS == jports.EPS
    a = tmsg.msg_new(3, dst=9, p0=-5, p1=2 ** 31 - 1, p2=7, p3=0)
    b = jmsg.msg_new(3, dst=9, p0=-5, p1=2 ** 31 - 1, p2=7, p3=0)
    assert a.dtype == torch.int32
    np.testing.assert_array_equal(as_np(a), np.asarray(b))
    r = tmsg.msg_reply(a, 4, p0=a[tmsg.W_SRC])
    np.testing.assert_array_equal(
        as_np(r), np.asarray(jmsg.msg_reply(b, 4, p0=b[jmsg.W_SRC])))
    assert int(tmsg.opcode(a)) == 3 and int(tmsg.payload(a, 1)) == 2 ** 31 - 1


# +-0, +-inf, quiet and signalling NaNs of both signs, the smallest
# subnormal, the largest finite value
SPECIAL_BITS = np.array([0x00000000, 0x80000000, 0x7F800000, 0xFF800000,
                         0x7FC00000, 0xFFC00000, 0x7F800001, 0xFFA00001,
                         0x00000001, 0x7F7FFFFF, 0x3F800000],
                        np.uint32).view(np.int32)


def test_bitcasts_keep_every_bit():
    bits = torch.as_tensor(SPECIAL_BITS)
    f = tmsg.i2f(bits)
    assert f.dtype == torch.float32
    np.testing.assert_array_equal(as_np(tmsg.f2i(f)), SPECIAL_BITS)
    np.testing.assert_array_equal(as_np(f).view(np.int32),
                                  np.asarray(jmsg.i2f(SPECIAL_BITS))
                                  .view(np.int32))
    # under vmap too (the engine runs tick functions there)
    fv = torch.func.vmap(tmsg.i2f)(bits)
    np.testing.assert_array_equal(as_np(torch.func.vmap(tmsg.f2i)(fv)),
                                  SPECIAL_BITS)
    # and through the custom op that stands in for view.dtype under vmap
    # on PyTorch releases without its batching rule
    fo = torch.func.vmap(lambda v: tmsg._bitcast_op(v, True))(bits)
    np.testing.assert_array_equal(as_np(fo).view(np.int32), SPECIAL_BITS)
    np.testing.assert_array_equal(
        as_np(torch.func.vmap(lambda v: tmsg._bitcast_op(v, False))(fo)),
        SPECIAL_BITS)
    assert int(tmsg.f2i(-0.0)) == int(jmsg.f2i(-0.0)) == -2 ** 31
    assert int(tmsg.f2i(float("inf"))) == int(jmsg.f2i(jnp.inf))
    assert float(tmsg.ready_time(tmsg.msg_new(1))) == 0.0


@pytest.mark.parametrize("ix", [-1, 0, 3, 4, 100])
def test_oh_set_matches_and_drops_out_of_range(ix):
    arr = np.arange(8, dtype=np.int32).reshape(4, 2)
    want = jports.oh_set(jnp.asarray(arr), ix, -7)
    got = tports.oh_set(torch.as_tensor(arr), torch.tensor(ix), -7)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(as_np(got), np.asarray(want))
    if not 0 <= ix < 4:
        np.testing.assert_array_equal(as_np(got), arr)
    off = tports.oh_set(torch.as_tensor(arr), ix, -7, when=False)
    np.testing.assert_array_equal(as_np(off), arr)


def _check_out_ring_fifo_and_capacity(ops, cap):
    """Random send(payload=i) sequences, in both packages: never exceed
    cap; contents FIFO; the two views stay equal field by field."""
    views = _replace(_empty(CAP=4), cap=np.full((1,), cap, np.int32))
    model = []
    sent_seq = 0
    for op in ops:
        j, t = views
        if op == 0:   # send
            j2, jok = j.send(0, jmsg.msg_new(1, p0=sent_seq))
            t2, tok = t.send(0, tmsg.msg_new(1, p0=sent_seq))
            assert bool(tok) == bool(jok) == (len(model) < cap)
            if bool(tok):
                model.append(sent_seq)
            views = (j2, t2)
            sent_seq += 1
        elif model:   # connection-side pop (head of out ring)
            head = t.out_buf[0, t.out_head[0]]
            assert int(head[4]) == model.pop(0)
            views = _replace(views, out_head=(as_np(t.out_head) + 1) % 4,
                             out_cnt=as_np(t.out_cnt) - 1)
        assert int(views[1].out_cnt[0]) == len(model)
        assert_same_state(views[1], views[0])


if HAVE_HYPOTHESIS:
    @settings(max_examples=30, deadline=None)
    @given(ops=st.lists(st.integers(0, 1), min_size=1, max_size=24),
           cap=st.integers(1, 4))
    def test_out_ring_fifo_and_capacity(ops, cap):
        _check_out_ring_fifo_and_capacity(ops, cap)
else:
    def test_out_ring_fifo_and_capacity():
        _check_out_ring_fifo_and_capacity([0, 0, 1, 0, 1, 1, 0, 0, 0, 1], 2)
        pytest.importorskip("hypothesis")


def test_out_ring_fixed_sequence():
    _check_out_ring_fifo_and_capacity([0, 0, 1, 0, 1, 1, 0, 0, 0, 0, 0, 1],
                                      3)


def test_recv_respects_ready_time():
    m = np.array(jmsg.msg_new(1, p0=7))
    m[jmsg.W_TIME] = np.float32(5.0).view(np.int32)
    buf = np.zeros((1, 4, 8), np.int32)
    buf[0, 0] = m
    views = _replace(_empty(), in_buf=buf, in_cnt=np.ones((1,), np.int32))
    out = []
    for now in (0.0, 4.999, 5.0):
        views = _replace(views, t=np.float32(now))
        (jm, jok, j2), (tm, tok, t2) = (v.recv(0) for v in views)
        np.testing.assert_array_equal(as_np(tm), np.asarray(jm))
        assert bool(tok) == bool(jok)
        assert_same_state(t2, j2)
        out.append((bool(tok), int(t2.in_cnt[0])))
    # 4.999 is within EPS of the ready time
    assert out == [(False, 1), (True, 0), (True, 0)]
    assert int(tm[4]) == 7


def test_send_fills_src_and_default_peer():
    views = _replace(_empty(), peer=np.full((1,), 42, np.int32),
                     gid=np.full((1,), 7, np.int32))
    (j2, jok), (t2, tok) = views[0].send(0, jmsg.msg_new(1)), \
        views[1].send(0, tmsg.msg_new(1))
    assert bool(tok) and bool(jok)
    assert_same_state(t2, j2)
    head = t2.out_buf[0, 0]
    assert int(head[1]) == 7 and int(head[2]) == 42
    # an explicit destination wins over the default peer
    (j3, _), (t3, _) = j2.send(0, jmsg.msg_new(1, dst=5)), \
        t2.send(0, tmsg.msg_new(1, dst=5))
    assert_same_state(t3, j3)
    assert int(t3.out_buf[0, 1, 2]) == 5


def test_two_ports_recv_and_send_touch_only_their_row():
    P = 3
    j, t = _empty(P=P, CAP=2)
    rng = np.random.default_rng(3)
    buf = rng.integers(-9, 9, (P, 2, 8)).astype(np.int32)
    buf[:, :, jmsg.W_TIME] = 0
    views = _replace((j, t), in_buf=buf, in_cnt=np.array([2, 1, 0], np.int32),
                     in_head=np.array([1, 0, 1], np.int32),
                     out_cnt=np.array([0, 2, 1], np.int32),
                     out_head=np.array([0, 1, 1], np.int32),
                     cap=np.array([2, 2, 1], np.int32),
                     peer=np.array([11, 12, 13], np.int32))
    for p in range(P):
        (jm, jok, j2), (tm, tok, t2) = (v.recv(p) for v in views)
        assert bool(tok) == bool(jok)
        np.testing.assert_array_equal(as_np(tm), np.asarray(jm))
        assert_same_state(t2, j2)
        (j3, jok), (t3, tok) = j2.send(p, jmsg.msg_new(2, p0=p)), \
            t2.send(p, tmsg.msg_new(2, p0=p))
        assert bool(tok) == bool(jok)
        assert_same_state(t3, j3)
        views = (j3, t3)
