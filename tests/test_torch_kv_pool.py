"""The port's ``PagedKVPool`` against the JAX package's, op for op.

One random schedule (numpy seed) of writes, prefix adoption, in-place
appends (``begin_append``/``commit_append``), allocations, releases,
protection and export/import is replayed on both pools.  After every op
both pools must agree exactly: return values, page lists, token counts and
ids, refcounts, the free list, the prefix index and ``stats``; both pass
``check_invariants``; and the bytes every session reads back are equal
(float32 contents are copied, never computed, so equality is exact).
"""

import numpy as np
import pytest

pytest.importorskip("jax")

import torch  # noqa: E402

from repro.configs.base import ModelConfig as JConfig  # noqa: E402
from repro.serving.kv_cache import PagedKVPool as JPool  # noqa: E402
from repro_torch.configs.base import ModelConfig as TConfig  # noqa: E402
from repro_torch.serving.kv_cache import PagedKVPool as TPool  # noqa: E402

L, HKV, DH, P, N_PAGES = 2, 2, 4, 4, 14


def _pools():
    kw = dict(arch_id="kvprop", family="dense", n_layers=L,
              d_model=HKV * DH, n_heads=HKV, n_kv_heads=HKV, dtype="float32")
    return (JPool(JConfig(**kw), n_pages=N_PAGES, page_size=P,
                  dtype=np.float32),
            TPool(TConfig(**kw), n_pages=N_PAGES, page_size=P,
                  device="cpu"))


def content(ids, offset=0.0):
    """K (or V) at position i of token t: f(t, i), as in the reference's
    pool invariant suite."""
    base = np.asarray([(t * 31 + i * 7) % 1000 for i, t in enumerate(ids)],
                      np.float32)
    out = base.reshape(1, -1, 1, 1) + np.arange(L, dtype=np.float32
                                                ).reshape(L, 1, 1, 1) * 1e4
    return np.broadcast_to(out, (L, len(ids), HKV, DH)).copy() + offset


def _state(pool):
    sess = {sid: (list(sp.pages), sp.tokens, list(sp.token_ids))
            for sid, sp in pool._sessions.items()}
    index = {parent: dict(ch) for parent, ch in pool._index.items()}
    return (sess, dict(pool._ref), list(pool._free), index,
            dict(pool._page_key), dict(pool.stats), set(pool._protected))


def _bytes(pool, sid):
    got = pool.gather_contiguous(sid, max_seq=N_PAGES * P)
    if got is None:
        return None
    k, v, tokens = got
    return (np.asarray(k[:, :tokens], np.float32),
            np.asarray(v[:, :tokens], np.float32))


def _append(pool, sid, full, n, is_torch):
    """The paged decode step on one session: reserve, write n positions in
    place, publish."""
    sp = pool.session(sid)
    if sp is None or not pool.begin_append(sid, n, 1.0):
        return False
    k, v = content(full), content(full, 0.5)
    for t in range(sp.tokens, sp.tokens + n):
        page, off = sp.pages[t // P], t % P
        if is_torch:
            pool.k[:, page, off] = torch.from_numpy(k[:, t])
            pool.v[:, page, off] = torch.from_numpy(v[:, t])
        else:
            pool.k = pool.k.at[:, page, off].set(k[:, t])
            pool.v = pool.v.at[:, page, off].set(v[:, t])
    pool.commit_append(sid, n, token_ids=full[-n:], now=1.0)
    return True


@pytest.mark.parametrize("seed", range(6))
def test_random_schedules_replay_identically(seed):
    rng = np.random.default_rng(seed)
    jpool, tpool = _pools()
    oracle = {}
    for step in range(40):
        now = float(step)
        op = rng.choice(["write", "share", "acquire", "append", "allocate",
                         "release", "protect", "migrate"])
        sids = sorted(oracle)
        sid = (sids[rng.integers(0, len(sids))] if sids and op not in
               ("write", "acquire") else f"s{rng.integers(0, 7)}")
        if op == "write" or (not sids and op != "allocate"):
            ids = [int(t) for t in rng.integers(0, 40, rng.integers(1, 15))]
            res = [p.write_session(sid, content(ids), content(ids, 0.5),
                                   len(ids), now=now, token_ids=ids)
                   for p in (jpool, tpool)]
            if res[0]:
                oracle[sid] = ids
        elif op == "share":
            donor = oracle[sid]
            cut = int(rng.integers(1, len(donor) + 1))
            ids = donor[:cut] + [int(t) for t in rng.integers(40, 80, 3)]
            new = f"c{rng.integers(0, 4)}"
            res = [p.write_session(new, content(ids), content(ids, 0.5),
                                   len(ids), now=now, token_ids=ids)
                   for p in (jpool, tpool)]
            if res[0]:
                oracle[new] = ids
        elif op == "acquire":
            if not sids:
                continue
            donor = oracle[sids[rng.integers(0, len(sids))]]
            res = [p.acquire_prefix(sid, donor, now=now)
                   for p in (jpool, tpool)]
            if res[0] > 0:
                oracle[sid] = donor[:res[0]]
        elif op == "append":
            n = int(rng.integers(1, 6))
            full = oracle[sid] + [int(t) for t in rng.integers(80, 99, n)]
            res = [_append(jpool, sid, full, n, False),
                   _append(tpool, sid, full, n, True)]
            if res[0]:
                oracle[sid] = full
        elif op == "allocate":
            n = int(rng.integers(1, 9))
            res = [p.allocate(f"raw{step % 3}", n, now=now) is not None
                   for p in (jpool, tpool)]
            oracle.pop(f"raw{step % 3}", None)
        elif op == "release":
            res = [p.release(sid) for p in (jpool, tpool)]
            oracle.pop(sid, None)
        elif op == "protect":
            res = [p.protect(sid) if step % 2 else p.unprotect(sid)
                   for p in (jpool, tpool)]
        else:   # migrate: export, import under another id
            pay = [p.export_session(sid) for p in (jpool, tpool)]
            if pay[0] is None:
                assert pay[1] is None
                continue
            np.testing.assert_array_equal(pay[1]["k"].numpy(),
                                          np.asarray(pay[0]["k"]))
            dst = f"m{rng.integers(0, 3)}"
            res = [p.import_session(dst, pl, now=now)
                   for p, pl in zip((jpool, tpool), pay)]
            if res[0]:
                oracle[dst] = list(pay[0]["token_ids"])
        assert res[0] == res[1], (step, op)
        jpool.check_invariants()
        tpool.check_invariants()
        assert _state(jpool) == _state(tpool), (step, op)
        for s in list(oracle):
            if jpool.session(s) is None or not jpool.session(s).pages:
                oracle.pop(s)
                continue
            jb, tb = _bytes(jpool, s), _bytes(tpool, s)
            np.testing.assert_array_equal(tb[0], jb[0])
            np.testing.assert_array_equal(tb[1], jb[1])
            np.testing.assert_array_equal(tb[0], content(oracle[s]))


def test_page_table_rows_match():
    jpool, tpool = _pools()
    ids = list(range(10))
    for p in (jpool, tpool):
        p.write_session("a", content(ids), content(ids, 0.5), 10,
                        token_ids=ids)
        p.acquire_prefix("b", ids[:7])
    for sid in ("a", "b", "missing"):
        np.testing.assert_array_equal(tpool.page_table(sid, 5),
                                      jpool.page_table(sid, 5))
    for probe in (ids, ids[:3], [7] + ids, ids[:4] + [99, 98, 97, 96, 95]):
        assert tpool.match_prefix(probe) == jpool.match_prefix(probe)
