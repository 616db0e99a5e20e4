"""The dense move scan's kernel entry point and its twin, on the CPU.

``ops.scan.move_scan_cuda`` (K3, ``csrc/move_scan.cu``) runs only on the
card, where tests/test_torch_cuda.py holds it to its twin. Here:

  - it refuses what it does not take before it loads the library;
  - ``_scan_plain`` on CPU tensors is the torch loop, bit for bit as the
    scan was before the kernel (the loop's text is kept below);
  - on (faked) CUDA tensors ``_scan_plain`` hands the kernel its arguments
    in order: a plain emulation of the kernel's arithmetic (the packed lower
    triangle of K^-1, the 2x2 algebra per move) in its place decides every
    move as the loop does and reads its log alphas within 1e-4.
"""

import numpy as np
import pytest
import torch

from bark_tpu_torch.benchmarks.tree_function import TreeFunction
from bark_tpu_torch.fitting import sampler
from bark_tpu_torch.fitting.params import SamplerParams
from bark_tpu_torch.forest import create_empty_forest
from bark_tpu_torch.ops import _build
from bark_tpu_torch.ops.scan import MAX_N, move_scan_cuda

CHAINS, N, PADS, TREES = 4, 24, 4, 10


def _loop_before_k3(state, batch, W_pat, y, mask, pad_count, params, beta):
    """``_scan_plain`` as it was before the kernel, verbatim."""
    h, mll_corr = sampler._scan_scales(state, pad_count, params)
    W_all = h[:, None, None, None] * W_pat
    K_inv = state.kern.K_inv
    v_y = K_inv @ y  # (C, N)
    book = sampler._MoveBook(batch, beta, v_y @ y, state.kern.K_logdet, mll_corr)
    for j in range(params.num_trees):
        W = W_all[:, j]  # (C, N, 2)
        Wt = W.transpose(-1, -2)
        V = K_inv @ W  # (C, N, 2)
        acc, Minv, u = book.move(j, Wt @ V, (Wt @ v_y[..., None])[..., 0])
        K_inv = torch.where(acc[:, None, None], K_inv - (V @ Minv) @ V.transpose(-1, -2), K_inv)
        v_y = torch.where(acc[:, None], v_y - (V @ u[..., None])[..., 0], v_y)
    return book.accepts, book.log_alphas


def _emulated_kernel(K_inv, y, W_pat, h, K_logdet, mll_corr, log_q_prior, u_accept, beta):
    """K3's arithmetic, chain by chain: K^-1 rebuilt from its lower
    triangle, the seed from the scan's own quadratic, per move the 2x2
    algebra of ``_rank2_terms`` and ``_accept`` on scalars."""
    c, m = log_q_prior.shape
    accepts = torch.zeros((c, m), dtype=torch.bool)
    log_alpha = torch.zeros((c, m), dtype=torch.float32)
    for ch in range(c):
        low = torch.tril(K_inv[ch])
        P = low + torch.tril(low, -1).T
        v_y = P @ y
        quad, logdet, corr = v_y @ y, K_logdet[ch], mll_corr[ch]
        cur = 0.5 * ((-quad - logdet) + corr)
        for j in range(m):
            W = h[ch] * W_pat[ch, j]
            V = P @ W
            A, B, Cc = W[:, 0] @ V[:, 0], W[:, 1] @ V[:, 1], W[:, 0] @ V[:, 1]
            t0, t1 = W[:, 0] @ v_y, W[:, 1] @ v_y
            denom1 = 1.0 + A
            detM = denom1 * (B - 1.0) - Cc * Cc
            m00, m01, m11 = (B - 1.0) / detM, -Cc / detM, denom1 / detM
            logdet2 = logdet + torch.log(-detM)
            u0, u1 = m00 * t0 + m01 * t1, m01 * t0 + m11 * t1
            quad2 = quad - (t0 * u0 + t1 * u1)
            mll2 = 0.5 * ((-quad2 - logdet2) + corr)
            if not -detM / denom1 > 1e-6:
                mll2 = torch.tensor(-torch.inf)
            la = log_q_prior[ch, j] + beta[ch] * (mll2 - cur)
            log_u = torch.log(u_accept[ch, j])
            acc = bool(log_u <= la) and bool(log_u <= 0)
            accepts[ch, j], log_alpha[ch, j] = acc, la
            if acc:
                logdet, quad, cur = logdet2, quad2, mll2
                v_y = v_y - (V[:, 0] * u0 + V[:, 1] * u1)
                P = P - (V @ torch.stack([torch.stack([m00, m01]), torch.stack([m01, m11])])) @ V.T
    return accepts, log_alpha


def _case(dtype, seed=0, steps=15):
    """A real state after ``steps`` sampler steps from empty forests and one
    step's proposal batch and patterns: (state, batch, W_pat, y, mask,
    pad_count, params)."""
    tf = TreeFunction(dim=5, m=TREES, function_seed=1)
    rng = np.random.default_rng(seed)
    X_np = tf.domain.sample(N, rng)
    y_np = tf.f(X_np)
    y_np = (y_np - y_np.mean()) / y_np.std()
    y_np[N - PADS:] = 0.0
    X = torch.as_tensor(X_np)
    y = torch.as_tensor(y_np, dtype=dtype)
    mask = torch.ones(N, dtype=dtype)
    mask[N - PADS:] = 0.0
    ft = torch.as_tensor(tf.domain.feature_types())
    bounds = torch.as_tensor(tf.domain.bounds("bitmask"))
    params = SamplerParams(warmup_steps=steps, num_samples=1, steps_per_sample=1,
                           num_chains=CHAINS, num_trees=TREES)
    model = sampler.BARKModel(create_empty_forest(TREES, params.node_limit, (CHAINS,), "cpu"),
                              torch.full((CHAINS,), 0.1, dtype=dtype),
                              torch.ones(CHAINS, dtype=dtype))
    gen = torch.Generator().manual_seed(seed)
    state = sampler.run_chain(gen, model, X, y, bounds, ft, params, mask=mask).state
    params = sampler._resolve_styles(params, N)
    draws = sampler.draw_step(gen, CHAINS, params)
    packed0, batch = sampler._propose_all_trees(state, X, ft, bounds, params, draws.proposal)
    W_pat = sampler._update_patterns(packed0, batch, mask)
    return state, batch, W_pat, y, mask, N - mask.sum(), params


def _beta(kind, dtype):
    """beta 1.0, one per chain, or one for all as an expanded view (SMC's)."""
    if kind == "one":
        return 1.0
    if kind == "expanded":
        return torch.tensor(0.7, dtype=dtype).expand(CHAINS)
    return torch.linspace(0.2, 1.0, CHAINS, dtype=dtype)


@pytest.mark.parametrize("beta", ["one", "per-chain"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_scan_plain_on_cpu_is_the_loop_bitwise(dtype, beta):
    args = _case(dtype)
    got = sampler._scan_plain(*args, _beta(beta, dtype))
    want = _loop_before_k3(*args, _beta(beta, dtype))
    assert len(got[0]) == len(want[0]) == TREES
    for g, w in zip(got[0] + got[1], want[0] + want[1]):
        assert torch.equal(g, w)
    assert 0 < torch.stack(got[0]).float().mean() < 1


@pytest.mark.parametrize("beta", ["one", "per-chain", "expanded"])
def test_scan_plain_hands_the_kernel_its_arguments(monkeypatch, beta):
    args = _case(torch.float32, seed=1)
    loop = sampler._scan_plain_loop(*args, _beta(beta, torch.float32))
    want_acc, want_la = (torch.stack(t, 1) for t in loop)
    seen = {}

    def kernel(*kargs):
        seen["args"] = kargs
        return _emulated_kernel(*kargs)

    monkeypatch.setattr(torch.Tensor, "is_cuda", property(lambda self: True))
    monkeypatch.setattr(sampler, "move_scan_cuda", kernel)
    acc, la = sampler._scan_plain(*args, _beta(beta, torch.float32))
    monkeypatch.undo()
    kb = seen["args"][-1]
    assert kb.shape == (CHAINS,) and kb.dtype == torch.float32 and kb.is_contiguous()
    if beta == "one":
        assert torch.equal(kb, torch.ones(CHAINS))
    assert all(t.dtype == torch.float32 and t.is_contiguous() for t in seen["args"])
    # decisions alike up to a near-tie (u within 1e-5 of the loop's p), log alphas within 1e-4
    p = torch.exp(torch.clamp_max(want_la, 0.0))
    tie = (args[1].u_accept - p).abs() <= 1e-5
    for ch in range(CHAINS):
        stop = int(torch.nonzero(tie[ch])[0]) if tie[ch].any() else TREES
        assert torch.equal(acc[ch, :stop], want_acc[ch, :stop])
        torch.testing.assert_close(la[ch, :stop], want_la[ch, :stop], rtol=0, atol=1e-4)


def _kernel_args(c=2, n=5, m=3, dtype=torch.float32):
    a = torch.eye(n, dtype=dtype).expand(c, n, n).contiguous()
    per_chain = torch.zeros(c, dtype=dtype)
    return dict(K_inv=a, y=torch.zeros(n, dtype=dtype),
                W_pat=torch.zeros((c, m, n, 2), dtype=dtype), h=per_chain + 1.0,
                K_logdet=per_chain, mll_corr=per_chain, log_q_prior=torch.zeros((c, m), dtype=dtype),
                u_accept=torch.full((c, m), 0.5, dtype=dtype), beta=per_chain + 1.0)


REFUSED = {
    "cpu tensors": (False, {}, "CUDA"),
    "float64": (True, dict(dtype=torch.float64), "float32"),
    "N=0": (True, dict(n=0), "outside"),
    f"N={MAX_N + 1}": (True, dict(n=MAX_N + 1, c=1, m=1), "outside"),
    "y of another length": (True, {"y": torch.zeros(6)}, "must be"),
    "W_pat without the pair": (True, {"W_pat": torch.zeros((2, 3, 5))}, "expected"),
    "beta a scalar": (True, {"beta": torch.ones(())}, "must be"),
    "u_accept of another m": (True, {"u_accept": torch.full((2, 4), 0.5)}, "must be"),
    "K_inv not contiguous": (True, {"K_inv": torch.eye(5).expand(2, 5, 5)}, "contiguous"),
}


@pytest.mark.parametrize("case", list(REFUSED))
def test_move_scan_cuda_refuses_before_loading(monkeypatch, case):
    faked, change, match = REFUSED[case]
    sizes = {k: v for k, v in change.items() if k in ("c", "n", "m", "dtype")}
    kwargs = _kernel_args(**sizes)
    kwargs.update({k: v for k, v in change.items() if k not in sizes})

    def no_library():
        raise AssertionError("the library was loaded")

    monkeypatch.setattr(_build, "load_library", no_library)
    if faked:
        monkeypatch.setattr(torch.Tensor, "is_cuda", property(lambda self: True))
    before = move_scan_cuda.launches
    with pytest.raises(ValueError, match=match):
        move_scan_cuda(**kwargs)
    assert move_scan_cuda.launches == before


def test_the_benchmark_reads_the_kernels_launches_a_step():
    """``scan_kernel_launches.mcmc`` counts device events named
    ``move_scan_kernel`` over the profiled steps: 0.0 without the kernel,
    nothing without a trace."""
    from perfbench.lib import registry
    from perfbench.lib.trace import Event, Trace

    reader = registry.metric_reader("scan_kernel_launches.mcmc")
    k3 = "(anonymous namespace)::move_scan_kernel(float const*, float const*, ...)"
    events = [Event(k3, 0, 5), Event("gram_kernel", 10, 5), Event(k3, 20, 5)]
    assert reader.read({"trace": Trace(events, [], 1.0), "profiled_steps": 2}) == 1.0
    assert reader.read({"trace": Trace(events[1:2], [], 1.0), "profiled_steps": 5}) == 0.0
    assert reader.read({}) is None
