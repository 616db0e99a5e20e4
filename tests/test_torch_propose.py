"""The proposal batch's kernel K4 and its twin.

``ops.propose.propose_batch_cuda`` (K4, ``csrc/propose.cu``) runs only on
the card. On the CPU:

  - it refuses what it does not take before it loads the library;
  - on (faked) CUDA tensors ``_propose_all_trees`` hands it its arguments
    under ``subspace_mode="walk"``: a kernel emulated by the twin
    (``_propose_torch``), and a scalar emulation of the kernel's own
    arithmetic (ballots and the first two free slots, the one-feature walk,
    the split draw, the edit, the leaves), each give the twin's batch;
  - ``subspace_mode="carry"`` never calls it;
  - the benchmark's reader counts its launches.

On the card (marked ``cuda``, run as tests/test_torch_cuda.py is), K4
against the twin at the benchmark cells' shapes and at forced rejects.
Every field is compared exactly but ``log_q_prior``: the kernel's logf and
powf and the twin's torch.log and torch.pow (or numpy's, in the scalar
emulation) may round the last bit apart, and each rounding moves log q by
an ulp of its terms, so it is held to 8 float32 ulps of max(1, |log q|).
"""

import numpy as np
import pytest
import torch

from bark_tpu_torch.fitting import sampler
from bark_tpu_torch.fitting.params import SamplerParams
from bark_tpu_torch.fitting.proposals import ProposalNoise, make_proposal_noise
from bark_tpu_torch.forest import (
    FEAT_CAT,
    FEAT_CONT,
    FEAT_INT,
    create_empty_forest,
    pack_forest,
    route_forest,
    unpack_forest,
)
from bark_tpu_torch.ops import _build
from bark_tpu_torch.ops import propose as K4
from bark_tpu_torch.ops.propose import MAX_NODES, propose_batch_cuda

LOG_Q_ULPS = 8


# --- cases: random trees grown by the twin's own proposals ---------------------------------

def _domain(kind, dtype=torch.float32):
    """(bounds (D, 2), feat_types (D,), a function drawing X (N, D) from a
    numpy generator) of a benchmark cell's inputs, or of the edge cases: a
    one-category and a one-value integer input, whose splits are always
    degenerate, beside well-posed ones."""
    cont, cat5 = (0.0, 1.0), (0.0, 31.0)
    if kind == "cont":
        rows, ft = [cont] * 5, [FEAT_CONT] * 5
    elif kind == "cat2":
        rows, ft = [cont] * 3 + [cat5] * 2, [FEAT_CONT] * 3 + [FEAT_CAT] * 2
    elif kind == "pest":
        rows, ft = [cat5] * 25, [FEAT_CAT] * 25
    else:
        rows = [(0.0, 1.0), (3.0, 3.0), cont, cat5, (-2.0, 9.0)]
        ft = [FEAT_CAT, FEAT_INT, FEAT_CONT, FEAT_CAT, FEAT_INT]
    bounds = torch.tensor(rows, dtype=dtype)
    ft_t = torch.tensor(ft, dtype=torch.int32)

    def draw_x(rng, n):
        cols = []
        for (lo, hi), f in zip(rows, ft):
            if f == FEAT_CAT:
                cols.append(rng.integers(0, int(hi).bit_length(), n).astype(np.float64))
            elif f == FEAT_INT:
                cols.append(rng.integers(int(lo), int(hi) + 1, n).astype(np.float64))
            else:
                cols.append(rng.uniform(lo, hi, n))
        return np.stack(cols, 1)

    return bounds, ft_t, draw_x


def _case(kind, chains, trees, n, node_limit=64, max_depth=16, grow_steps=30, seed=0,
          dtype=torch.float32, device="cpu"):
    """A batch's inputs: forests grown by ``grow_steps`` rounds of the
    twin's proposals, every one kept (a reject leaves its tree as it was),
    X with the current leaves (C, N, m, the routed view), fresh noise and
    the params."""
    bounds, ft, draw_x = _domain(kind, dtype)
    params = SamplerParams(num_chains=chains, num_trees=trees, node_limit=node_limit,
                           max_depth=max_depth)
    gen = torch.Generator().manual_seed(seed)
    packed = pack_forest(create_empty_forest(trees, node_limit, (chains,)))
    for _ in range(grow_steps):
        noise = make_proposal_noise(gen, trees, node_limit, (chains,))
        flat = packed.reshape(chains * trees, node_limit, 8)
        new = sampler.propose_tree_packed(
            flat, bounds, ft, params, ProposalNoise(*(t.reshape(chains * trees, *t.shape[2:])
                                                     for t in noise)))[0]
        packed = new.reshape(packed.shape)
    X = torch.as_tensor(draw_x(np.random.default_rng(seed), n), dtype=dtype)
    leaves = route_forest(unpack_forest(packed), X, ft, max_depth)
    noise = make_proposal_noise(gen, trees, node_limit, (chains,))
    to = lambda t: t.to(device)  # noqa: E731
    return (to(packed), ProposalNoise(*map(to, noise)), to(leaves), to(X), to(ft), to(bounds),
            params)


def _assert_batch_equal(got, want):
    """The six batch fields: all exact but log q (LOG_Q_ULPS ulps)."""
    names = ("new_packed", "cur_leavesT", "new_leavesT", "log_q_prior", "move", "node")
    for name, g, w in zip(names, got, want):
        assert g.shape == w.shape and g.dtype == w.dtype, (name, g.shape, w.shape, g.dtype)
        if name != "log_q_prior":
            assert torch.equal(g, w), name
            continue
        assert torch.equal(torch.isinf(g), torch.isinf(w)), name
        fin = torch.isfinite(w)
        ulp = torch.finfo(torch.float32).eps * torch.clamp_min(w[fin].abs(), 1.0)
        assert ((g[fin] - w[fin]).abs() <= LOG_Q_ULPS * ulp).all(), (g[fin] - w[fin]).abs().max()


# --- a scalar emulation of the kernel ------------------------------------------------------

def _next_pow2(x):
    return 1 << (min(x.bit_length(), 25) if x >= 1 else 0)


def _scatter_bits(r, mask, c):
    out, rank = 0, 0
    for i in range(25):
        if (mask >> i) & 1:
            if (r >> rank) & 1:
                out |= 1 << i
            rank += 1
    return 0 if c < 2 else out


def _emulated_kernel(packed, u_move, g_node, u_feat, u_cat, u_int, u_cont, bounds, feat_types,
                     X, leaves, proposal_weights, alpha, beta, max_depth):
    """K4 pair by pair on numpy scalars, in the kernel's order: the masks,
    the first two inactive slots and the Gumbel argmax; one feature's
    bounds by the walk (none for a prune); the split draw; the reject; log
    q in float32; the edit of the tree; the leaves from the node's row."""
    f32 = np.float32
    TB, TX = bounds.numpy().dtype.type, X.numpy().dtype.type
    cdf0, cdf1, log_alpha = map(f32, K4._constants(tuple(proposal_weights), float(alpha)))
    P = packed.numpy()
    B, Xn, ftn, lv = bounds.numpy(), X.numpy(), feat_types.numpy(), leaves.numpy()
    c, m, nl, _ = P.shape
    n, d = Xn.shape
    new_packed = P.copy()
    cur_out = np.zeros((c, m, n), np.int32)
    new_out = np.zeros((c, m, n), np.int32)
    log_q_out = np.zeros((c, m), np.float32)
    move_out = np.zeros((c, m), np.int32)
    node_out = np.zeros((c, m), np.int32)

    def pw(x):
        return x * x if beta == 2.0 else f32(x ** f32(beta))

    for ch in range(c):
        for j in range(m):
            t = P[ch, j].copy()
            leaf = lambda s: 0 <= s < nl and t[s, 0] != 0  # noqa: E731
            si = lambda s: (0 <= s < nl and t[s, 7] != 0 and t[s, 0] == 0  # noqa: E731
                            and leaf(t[s, 3]) and leaf(t[s, 4]))
            um = u_move[ch, j].item()
            move = int(f32(um) >= cdf0) + int(f32(um) >= cdf1)
            grow, prune = move == 0, move == 1
            term = [t[s, 7] != 0 and t[s, 0] != 0 for s in range(nl)]
            sis = [si(s) for s in range(nl)]
            valid = term if grow else sis
            free = [s for s in range(nl) if t[s, 7] == 0]
            g = g_node[ch, j].numpy()
            node, best = 0, -np.inf
            for s in range(nl):
                if valid[s] and g[s] > best:
                    node, best = s, g[s]
            i1 = free[0] if free else 0
            i2 = free[1] if len(free) >= 2 else 0
            l_old, r_old, parent_n, depth_n = (int(v) for v in t[node, 3:7])
            feat = min(int(f32(u_feat[ch, j].item()) * f32(d)), d - 1)
            ftype = int(ftn[feat])
            thr, invalid = TB(0), False
            if not prune:
                lo, hi = TB(B[feat, 0]), TB(B[feat, 1])
                at = node
                for _ in range(max_depth):
                    if at == 0:
                        break
                    parent = int(t[at, 5])
                    prow = t[parent]
                    if prow[1] == feat:
                        pthr = prow[2:3].view(np.float32)[0]
                        is_left = at == prow[3]
                        if ftype == FEAT_CAT:
                            ti, ui = int(pthr), int(hi)
                            hi = TB(ti & ui if is_left else (_next_pow2(ui) - 1 - ti) & ui)
                        elif is_left:
                            hi = min(TB(pthr), hi)
                        else:
                            lo = max(TB(pthr) + TB(1 if ftype == FEAT_INT else 0), lo)
                    at = parent
                if ftype == FEAT_CAT:
                    mask = int(hi)
                    cnt = bin(mask & 0xFFFFFFFF).count("1")
                    span = max(((1 << cnt) - 1 if cnt < 32 else -1) - 1, 1)
                    r = 1 + min(int(f32(u_cat[ch, j].item()) * f32(span)), span - 1)
                    thr = TB(_scatter_bits(r, mask, cnt))
                elif ftype == FEAT_INT:
                    li, ui = int(lo), int(hi)
                    drawn = li + min(int(f32(u_int[ch, j].item()) * f32(ui - li)), max(ui - li - 1, 0))
                    thr = TB(ui if li == ui else drawn)
                else:
                    thr = TB(np.float64(lo) + np.float64(u_cont[ch, j].item()) * np.float64(hi - lo))
                invalid = (ftype == FEAT_CAT and thr == 0) or (ftype == FEAT_INT and thr == hi)
            reject = (sum(valid) == 0 or (not prune and invalid)
                      or (grow and (len(free) < 2 or depth_n + 1 > max_depth)))
            log_q = f32(-np.inf)
            if not reject:
                q = pr = f32(0.0)
                if grow or prune:
                    w0, w1 = f32(sum(term)), f32(sum(sis))
                    if grow:
                        w1s = (w1 + f32(1.0)) - f32(node != 0 and si(parent_n))
                        q = np.log(w0) - np.log(w1s)
                    else:
                        q = np.log(w1) - np.log(max(w0 - f32(1.0), f32(1.0)))
                    df = f32(depth_n)
                    a = (f32(1.0) / pw(df + f32(2.0))) * f32(alpha)
                    pr = (log_alpha + np.log(f32(1.0) - a) * f32(2.0)
                          - np.log(pw(df + f32(1.0)) - f32(alpha)))
                    pr = -pr if prune else pr
                log_q = f32(q + pr)
                thr_bits = np.array([thr], np.float32).view(np.int32)[0]
                if grow:
                    t[i1] = t[i2] = (1, 0, 0, 0, 0, node, depth_n + 1, 1)
                    t[node] = (0, feat, thr_bits, i1, i2, parent_n, depth_n, 1)
                elif prune:
                    t[l_old, 7] = t[r_old, 7] = 0
                    t[node, 0] = 1
                else:
                    t[node, 1], t[node, 2] = feat, thr_bits
            new_packed[ch, j] = t
            log_q_out[ch, j], move_out[ch, j], node_out[ch, j] = log_q, move, node
            f_new = int(t[node, 1])
            thr_new = t[node, 2:3].view(np.float32)[0]
            for i in range(n):
                cur = int(lv[ch, i, j])
                x = TX(Xn[i, f_new])
                if ftn[f_new] == FEAT_CAT:
                    left = ((1 << min(max(int(x), 0), 31)) & int(thr_new)) != 0
                else:
                    left = x <= TX(thr_new)
                split_to = t[node, 3] if left else t[node, 4]
                children = cur in (l_old, r_old)
                if grow:
                    nv = split_to if cur == node else cur
                elif prune:
                    nv = node if children else cur
                else:
                    nv = split_to if children else cur
                cur_out[ch, j, i], new_out[ch, j, i] = cur, nv
    return tuple(torch.as_tensor(a) for a in (new_packed, cur_out, new_out, log_q_out,
                                              move_out, node_out))


def _twin_kernel(packed, u_move, g_node, u_feat, u_cat, u_int, u_cont, bounds, feat_types, X,
                 leaves, proposal_weights, alpha, beta, max_depth):
    """A kernel emulated by the twin, from the kernel's arguments alone."""
    params = SamplerParams(num_trees=packed.shape[1], node_limit=packed.shape[2],
                           max_depth=max_depth, alpha=alpha, beta=beta)
    assert params.proposal_weights == tuple(proposal_weights)
    noise = ProposalNoise(u_move, g_node, u_feat, u_cat, u_int, u_cont, torch.ones_like(u_move))
    return sampler._propose_torch(packed, noise, leaves, X, feat_types, bounds, params)[:6]


class _State:
    def __init__(self, packed, leaves, subspaces=None):
        self.forest = unpack_forest(packed)
        self.leaves = leaves
        self.subspaces = subspaces


CPU_CASES = {
    "cont (mcmc.treefn5.n50)": dict(kind="cont", chains=3, trees=6, n=20),
    "cat2": dict(kind="cat2", chains=3, trees=6, n=20, seed=1),
    "pest25": dict(kind="pest", chains=2, trees=6, n=24, seed=2),
    "rejects, float64": dict(kind="edges", chains=3, trees=8, n=9, node_limit=8, max_depth=2,
                             grow_steps=12, seed=3, dtype=torch.float64),
    "one point": dict(kind="cat2", chains=2, trees=4, n=1, seed=4),
}


@pytest.mark.parametrize("emulation", ["twin", "scalar"])
@pytest.mark.parametrize("case", list(CPU_CASES))
def test_propose_all_trees_hands_the_kernel_its_arguments(monkeypatch, case, emulation):
    packed, noise, leaves, X, ft, bounds, params = _case(**CPU_CASES[case])
    want = sampler._propose_torch(packed, noise, leaves, X, ft, bounds, params)
    assert want[-1] is None
    seen = {}

    def kernel(*args):
        seen["args"] = args
        return (_twin_kernel if emulation == "twin" else _emulated_kernel)(*args)

    monkeypatch.setattr(torch.Tensor, "is_cuda", property(lambda self: True))
    monkeypatch.setattr(sampler, "propose_batch_cuda", kernel)
    packed0, batch = sampler._propose_all_trees(_State(packed, leaves), X, ft, bounds, params,
                                                noise)
    monkeypatch.undo()
    assert torch.equal(packed0, packed)
    args = seen["args"]
    assert args[0] is packed0 and args[10] is leaves
    assert all(a.is_contiguous() for a in args[:10])
    assert args[11:] == (params.proposal_weights, params.alpha, params.beta, params.max_depth)
    _assert_batch_equal(batch[:6], want[:6])
    assert batch.u_accept is noise.u_accept and batch.new_subs is None
    moves = batch.move.flatten().tolist()
    assert {0, 1, 2} <= set(moves) or case == "one point"
    if case.startswith("rejects"):  # empty sets, degenerate splits, full trees, the depth cap
        assert torch.isinf(batch.log_q_prior).float().mean() > 0.3


def test_carry_never_calls_the_kernel(monkeypatch):
    packed, noise, leaves, X, ft, bounds, params = _case("cat2", 2, 4, 10)
    params = params.with_(subspace_mode="carry")
    from bark_tpu_torch.fitting.traversal import all_node_subspaces

    subs = all_node_subspaces(unpack_forest(packed), bounds, ft, params.max_depth)

    def kernel(*args):
        raise AssertionError("the carry called K4")

    monkeypatch.setattr(torch.Tensor, "is_cuda", property(lambda self: True))
    monkeypatch.setattr(sampler, "propose_batch_cuda", kernel)
    _, batch = sampler._propose_all_trees(_State(packed, leaves, subs), X, ft, bounds, params,
                                          noise)
    monkeypatch.undo()
    assert batch.new_subs.shape == subs.shape


def _kernel_args(c=2, m=3, nl=8, n=5, d=4):
    packed = pack_forest(create_empty_forest(m, nl, (c,)))
    u = lambda *s: torch.full(s, 0.5)  # noqa: E731
    return dict(packed=packed, u_move=u(c, m), g_node=u(c, m, nl), u_feat=u(c, m),
                u_cat=u(c, m), u_int=u(c, m), u_cont=u(c, m),
                bounds=torch.tensor([[0.0, 1.0]] * d), feat_types=torch.full((d,), 2, dtype=torch.int32),
                X=torch.zeros(n, d), leaves=torch.zeros((c, n, m), dtype=torch.int32),
                proposal_weights=(0.25, 0.25, 0.5), alpha=0.95, beta=2.0, max_depth=16)


REFUSED = {
    "cpu tensors": (False, {}, "CUDA"),
    "packed int64": (True, {"packed": torch.zeros((2, 3, 8, 8), dtype=torch.int64)}, "int32"),
    "packed without its 8 columns": (True, {"packed": torch.zeros((2, 3, 8), dtype=torch.int32)},
                                     "expected"),
    "g_node float64": (True, {"g_node": torch.zeros((2, 3, 8), dtype=torch.float64)}, "float32"),
    "g_node of another node_limit": (True, {"g_node": torch.zeros((2, 3, 9))}, "must be"),
    "u_move of another m": (True, {"u_move": torch.zeros((2, 4))}, "must be"),
    "bounds int32": (True, {"bounds": torch.zeros((4, 2), dtype=torch.int32)}, "float"),
    "feat_types of another D": (True, {"feat_types": torch.zeros(5, dtype=torch.int32)},
                                "must be"),
    "X of another D": (True, {"X": torch.zeros(5, 3)}, "must be"),
    "leaves of another N": (True, {"leaves": torch.zeros((2, 6, 3), dtype=torch.int32)},
                            "must be"),
    "u_cont not contiguous": (True, {"u_cont": torch.zeros((3, 2)).T}, "contiguous"),
    f"node_limit {MAX_NODES + 1}": (True, dict(nl=MAX_NODES + 1), "outside"),
    "max_depth -1": (True, {"max_depth": -1}, "max_depth"),
}


@pytest.mark.parametrize("case", list(REFUSED))
def test_propose_batch_cuda_refuses_before_loading(monkeypatch, case):
    faked, change, match = REFUSED[case]
    sizes = {k: v for k, v in change.items() if k in ("c", "m", "nl", "n", "d")}
    kwargs = _kernel_args(**sizes)
    kwargs.update({k: v for k, v in change.items() if k not in sizes})

    def no_library():
        raise AssertionError("the library was loaded")

    monkeypatch.setattr(_build, "load_library", no_library)
    if faked:
        monkeypatch.setattr(torch.Tensor, "is_cuda", property(lambda self: True))
    before = propose_batch_cuda.launches
    with pytest.raises(ValueError, match=match):
        propose_batch_cuda(**kwargs)
    assert propose_batch_cuda.launches == before


def test_the_benchmark_reads_the_kernels_launches_a_step():
    """``propose_kernel_launches.mcmc`` counts device events named
    ``propose_kernel`` over the profiled steps: 0.0 without the kernel,
    nothing without a trace."""
    from perfbench.lib import registry
    from perfbench.lib.trace import Event, Trace

    reader = registry.metric_reader("propose_kernel_launches.mcmc")
    k4 = "void (anonymous namespace)::propose_kernel<float, float>(int4 const*, ...)"
    events = [Event(k4, 0, 5), Event("move_scan_kernel", 10, 5), Event(k4, 20, 5)]
    assert reader.read({"trace": Trace(events, [], 1.0), "profiled_steps": 2}) == 1.0
    assert reader.read({"trace": Trace(events[1:2], [], 1.0), "profiled_steps": 5}) == 0.0
    assert reader.read({}) is None


# --- on the card -----------------------------------------------------------------------------

@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


CUDA_CASES = {
    "mcmc.treefn5.n50": dict(kind="cont", chains=64, trees=50, n=50),
    "mcmc.treefn5.n50.cat2": dict(kind="cat2", chains=64, trees=50, n=50, seed=1),
    "bo.treefn5.n50, padded N 64": dict(kind="cont", chains=4, trees=50, n=64, seed=2),
    "bo.pest25.n120": dict(kind="pest", chains=4, trees=50, n=128, seed=3),
    "N 1": dict(kind="cat2", chains=8, trees=50, n=1, seed=4),
    "N 300": dict(kind="cont", chains=8, trees=50, n=300, seed=5),
    "rejects, float64": dict(kind="edges", chains=16, trees=50, n=33, node_limit=8, max_depth=2,
                             grow_steps=12, seed=6, dtype=torch.float64),
    "rejects, float32, node_limit 1024": dict(kind="edges", chains=2, trees=20, n=40,
                                             node_limit=1024, max_depth=3, grow_steps=20,
                                             seed=7),
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(CUDA_CASES))
def test_propose_kernel_matches_its_twin(dev, case):
    packed, noise, leaves, X, ft, bounds, params = _case(**CUDA_CASES[case], device=dev)
    before = propose_batch_cuda.launches
    packed0, batch = sampler._propose_all_trees(_State(packed, leaves), X, ft, bounds, params,
                                                noise)
    torch.cuda.synchronize()
    assert propose_batch_cuda.launches == before + 1
    want = sampler._propose_torch(packed, noise, leaves, X, ft, bounds, params)
    _assert_batch_equal(batch[:6], want[:6])
    assert torch.equal(packed0, packed)
    if case.startswith("rejects"):
        assert torch.isinf(batch.log_q_prior).float().mean() > 0.3


@pytest.mark.cuda
def test_step_with_info_launches_the_kernel_once(dev):
    """20 steps of the dense tier at 64 chains on cat2's inputs: one K4
    launch a step, none in the init; then, on the forests the sampler grew,
    one more batch equal to the twin's."""
    from bark_tpu_torch.fitting.sampler import BARKModel, draw_step, run_chain

    bounds, ft, draw_x = _domain("cat2")
    bounds, ft = bounds.to(dev), ft.to(dev)
    X_np = draw_x(np.random.default_rng(0), 50)
    y_np = np.sin(3 * X_np[:, 0]) + (X_np[:, 3] == 1)
    X = torch.as_tensor(X_np, dtype=torch.float32, device=dev)
    y = torch.as_tensor((y_np - y_np.mean()) / y_np.std(), dtype=torch.float32, device=dev)
    params = SamplerParams(warmup_steps=0, num_samples=4, steps_per_sample=5, num_chains=64,
                           num_trees=50)
    model = BARKModel(create_empty_forest(50, params.node_limit, (64,), dev),
                      torch.full((64,), 0.1, device=dev), torch.ones(64, device=dev))
    gen = torch.Generator(device=dev).manual_seed(0)
    before = propose_batch_cuda.launches
    run = run_chain(gen, model, X, y, bounds, ft, params)
    torch.cuda.synchronize()
    assert propose_batch_cuda.launches - before == 20
    assert 0 < run.tree_accept_rate.mean().item() < 1
    noise = draw_step(gen, 64, params, dev).proposal
    _, batch = sampler._propose_all_trees(run.state, X, ft, bounds, params, noise)
    want = sampler._propose_torch(pack_forest(run.state.forest), noise, run.state.leaves, X, ft,
                                  bounds, params)
    _assert_batch_equal(batch[:6], want[:6])
