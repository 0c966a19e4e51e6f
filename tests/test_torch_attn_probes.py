"""Attention probes of the PyTorch port (orbit2_tpu_torch/ops/attn_probes.py)
and their CLI (orbit2_tpu_torch/scripts/bench_attn2.py).

CPU: each probe's plain version (the path its wrapper takes for CPU tensors)
against the Pallas kernel body of scripts/bench_attn2.py, run through
pl.pallas_call(..., interpret=True) with the script's BlockSpecs (BQ 64, one
kv block BK = N_k), on the same bf16 inputs. Tolerance: atol 1e-2 x the
row's max|o| over its 64 outputs and rtol 1e-2, for the bf16 rounding of s
or p and of o, which may fall on the other side of a tie where the fp32 sums
run in another order. The scale is per row because the unscaled scores make
rows differ by orders of magnitude: over the whole tensor, a probe that
drops a kv tile would pass (a test below checks that it fails). The JAX
bound shift traces only at N_k = 128 (a test below documents the broadcast
error elsewhere), so the port's bound shift is also held against the float64
softmax at N 256 and 512 (atol 1e-2).

CUDA (marker `cuda`, skipped without a card): the kernels against the plain
versions on the card. JAX is imported only inside the CPU parity tests:
`python -m pytest --noconftest -m cuda tests/test_torch_attn_probes.py`.
"""

import numpy as np
import pytest
import torch

from orbit2_tpu_torch.ops import attn_probes as ap

BQ = 64  # the JAX probes' query block at this size
REL = 1e-2
PROBES = {
    "matmul_only": (ap.matmul_only, "_kern_matmul_only"),
    "exp_noreduce": (ap.exp_noreduce, "_kern_exp_noreduce"),
    "full_softmax": (ap.full_softmax, "_kern_full_softmax"),
}
KERNELS = {"matmul_only": ap.PROBE_MATMUL_ONLY, "exp_noreduce": ap.PROBE_EXP_NOREDUCE,
           "full_softmax": ap.PROBE_FULL_SOFTMAX, "bound_shift": ap.PROBE_BOUND_SHIFT}


def make_qkv(bh, n, d=64, seed=0):
    """q, k, v [bh, n, d] bf16 (torch) from a numpy seed."""
    rng = np.random.default_rng(seed)
    return tuple(torch.from_numpy(rng.normal(size=(bh, n, d)).astype(np.float32))
                 .to(torch.bfloat16) for _ in range(3))


def beyond_rel(got, want):
    """Count of values of got beyond atol REL x max|want| of their row (last
    dim) and rtol REL."""
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    mag = np.abs(want)
    tol = REL * mag.max(axis=-1, keepdims=True) + REL * mag
    return int((~(np.abs(got - want) <= tol)).sum())


def assert_close_rel(got, want, what=""):
    bad = beyond_rel(got, want)
    assert bad == 0, f"{what}: {bad} values beyond atol {REL:g} x their row's max|o|, rtol {REL:g}"


def jax_call(kern, inputs, widths, n_k):
    """o of a scripts/bench_attn2.py kernel body on [BH, N, .] inputs through
    pl.pallas_call in interpret mode with the script's BlockSpecs (:91-103,
    :121-134): the query-side inputs in blocks of BQ rows, the kv side in one
    block of n_k rows. `widths` gives each input's last dim and whether it is
    query-side."""
    import jax
    import jax.numpy as jnp
    from jax.experimental import pallas as pl

    bh, n, _ = inputs[0].shape
    specs = [pl.BlockSpec((1, BQ, w), lambda b, i: (b, i, 0)) if q_side
             else pl.BlockSpec((1, n_k, w), lambda b, i: (b, 0, 0)) for w, q_side in widths]
    fn = pl.pallas_call(kern, grid=(bh, n // BQ), in_specs=specs,
                        out_specs=pl.BlockSpec((1, BQ, 64), lambda b, i: (b, i, 0)),
                        out_shape=jax.ShapeDtypeStruct((bh, n, 64), jnp.bfloat16),
                        interpret=True)
    return np.asarray(fn(*inputs), np.float32)


def to_jax(*ts):
    import jax.numpy as jnp

    return tuple(jnp.asarray(t.float().numpy(), jnp.bfloat16) for t in ts)


def jax_bound_shift(q, k, v):
    """run_bound's `outer` (scripts/bench_attn2.py:112-135) at BH = q's, with
    the kernel in interpret mode."""
    pytest.importorskip("jax")
    import jax.numpy as jnp

    from scripts import bench_attn2 as ref

    q, k, v = to_jax(q, k, v)
    bh, n, d = q.shape
    qs = (q.astype(jnp.float32) * ((d ** -0.5) * 1.4426950408889634)).astype(jnp.bfloat16)
    qn = jnp.linalg.norm(qs.astype(jnp.float32), axis=-1)
    kn = jnp.max(jnp.linalg.norm(k.astype(jnp.float32), axis=-1), axis=-1)
    bound = jnp.broadcast_to((qn * kn[:, None])[:, :, None], (bh, n, 128)).astype(jnp.float32)
    vx = jnp.concatenate([v, jnp.ones((bh, n, 128 - d), jnp.bfloat16)], axis=-1)
    o = jax_call(ref._kern_bound_shift, (bound, qs, k, vx),
                 [(128, True), (d, True), (d, False), (128, False)], n)
    return o, np.asarray(qs, np.float32), np.asarray(bound[:, :, 0])


@pytest.mark.parametrize("n", [128, 256])
@pytest.mark.parametrize("probe", list(PROBES))
def test_probe_matches_jax_pallas(probe, n):
    pytest.importorskip("jax")
    from scripts import bench_attn2 as ref

    wrapper, kern = PROBES[probe]
    q, k, v = make_qkv(2, n, seed=n)
    want = jax_call(getattr(ref, kern), to_jax(q, k, v), [(64, True), (64, False), (64, False)], n)
    got = wrapper(q, k, v)
    assert got.dtype == torch.bfloat16 and got.shape == q.shape
    assert_close_rel(got.float().numpy(), want, probe)


def test_bound_shift_matches_jax_pallas():
    """At N_k = 128, the one size at which the JAX kernel traces: the inputs
    of bound_shift_inputs equal run_bound's, and the output its kernel's."""
    q, k, v = make_qkv(2, 128, seed=3)
    want, want_qs, want_bound = jax_bound_shift(q, k, v)
    qs, bound = ap.bound_shift_inputs(q, k)
    np.testing.assert_array_equal(qs.float().numpy(), want_qs)
    np.testing.assert_allclose(bound.numpy(), want_bound, rtol=1e-6, atol=0)
    assert_close_rel(ap.bound_shift(qs, k, v, bound).float().numpy(), want, "bound_shift")


def test_jax_bound_shift_fails_to_trace_beyond_128_keys():
    """The reference's fault: `_kern_bound_shift` subtracts the lane-replicated
    bound (BQ, 128) from the scores (BQ, BK) (scripts/bench_attn2.py:83),
    which broadcast only when BK = 128. The port takes one bound per row."""
    q, k, v = make_qkv(1, 256, seed=4)
    with pytest.raises(TypeError, match="broadcast"):
        jax_bound_shift(q, k, v)


@pytest.mark.parametrize("n", [256, 512])
def test_bound_shift_matches_float64_softmax(n):
    q, k, v = make_qkv(2, n, seed=n + 1)
    qs, bound = ap.bound_shift_inputs(q, k)
    o = ap.bound_shift(qs, k, v, bound)
    qf, kf, vf = (t.double().numpy() for t in (q, k, v))
    s = np.einsum("bqd,bkd->bqk", qf, kf) * 64 ** -0.5
    p = np.exp(s - s.max(-1, keepdims=True))
    want = np.einsum("bqk,bkd->bqd", p / p.sum(-1, keepdims=True), vf)
    np.testing.assert_allclose(o.double().numpy(), want, atol=1e-2, rtol=0)
    np.testing.assert_allclose(ap.softmax_attention(q, k, v).numpy(), want, atol=1e-5, rtol=0)


@pytest.mark.parametrize("bh,n", [(2, 2048), (4, 192)])
@pytest.mark.parametrize("probe", list(KERNELS))
def test_tolerance_fails_a_probe_without_its_last_kv_tile(probe, bh, n):
    """The per-row tolerance bites at the shapes the card checks (N 2048 and
    192): the plain version run without the last 64 keys fails it, also where
    only the rows whose largest scores fall in that tile change (exp2 of
    unscaled scores)."""
    q, k, v = make_qkv(bh, n, seed=n + bh)
    cut = tuple(t[:, :-ap.BLOCK] for t in (k, v))
    if probe == "bound_shift":
        qs, bound = ap.bound_shift_inputs(q, k)
        want = ap.bound_shift_reference(qs, k, v, bound)
        got = ap.bound_shift_reference(qs, *cut, bound)
    else:
        plain = getattr(ap, f"{probe}_reference")
        want, got = plain(q, k, v), plain(q, *cut)
    assert beyond_rel(got.float().numpy(), want.float().numpy()) > 0


def test_cpu_tensors_take_the_plain_versions_without_launching():
    q, k, v = make_qkv(1, 64)
    qs, bound = ap.bound_shift_inputs(q, k)
    before = {name: kern.launches for name, kern in KERNELS.items()}
    pairs = [(ap.matmul_only(q, k, v), ap.matmul_only_reference(q, k, v)),
             (ap.exp_noreduce(q, k, v), ap.exp_noreduce_reference(q, k, v)),
             (ap.full_softmax(q, k, v), ap.full_softmax_reference(q, k, v)),
             (ap.bound_shift(qs, k, v, bound), ap.bound_shift_reference(qs, k, v, bound))]
    assert {name: kern.launches for name, kern in KERNELS.items()} == before
    for got, want in pairs:
        torch.testing.assert_close(got, want, atol=0, rtol=0)


def test_cli_runs_every_variant_on_the_cpu():
    from orbit2_tpu_torch.ops.flash_attention import FLASH_FWD
    from orbit2_tpu_torch.scripts import bench_attn2

    before = FLASH_FWD.launches, {name: kern.launches for name, kern in KERNELS.items()}
    res = bench_attn2.run(1, 128, 2, 64, "cpu")
    assert [name for name, _ in res["times"]] == [
        "matmul-only ceiling", "matmul+exp2 (no reductions)", "two-sweep full softmax",
        "bound-shift one-pass", "bound-shift + preparation", "flash forward (K1)"]
    assert all(ms is None for _, ms in res["times"])  # nothing is timed off the card
    assert res["flops"] == 4 * 2 * 128 * 128 * 64
    assert 0 < res["bound_shift_err"] < 1e-2
    assert (FLASH_FWD.launches, {name: kern.launches for name, kern in KERNELS.items()}) == before


@pytest.mark.parametrize("case", ["d32", "n100", "fp32", "rank4", "bound_fp64", "two_devices"])
def test_wrappers_raise_on_what_the_kernels_do_not_take(case):
    q, k, v = make_qkv(1, 128)
    qs, bound = ap.bound_shift_inputs(q, k)
    if case == "d32":
        q, k, v = make_qkv(1, 128, d=32)
        with pytest.raises(ValueError, match="head dim"):
            ap.matmul_only(q, k, v)
    elif case == "n100":
        q, k, v = make_qkv(1, 100)
        with pytest.raises(ValueError, match="multiple of 64"):
            ap.full_softmax(q, k, v)
    elif case == "fp32":
        with pytest.raises(TypeError, match="bfloat16"):
            ap.exp_noreduce(q.float(), k.float(), v.float())
    elif case == "rank4":
        with pytest.raises(ValueError, match="one shape"):
            ap.matmul_only(q[None], k[None], v[None])
    elif case == "bound_fp64":
        with pytest.raises(ValueError, match="bound"):
            ap.bound_shift(qs, k, v, bound.double())
    else:
        with pytest.raises(ValueError, match="one cpu or cuda device"):
            ap.matmul_only(q, k.to("meta"), v)


# ---- on the card -------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def run_probe(name, q, k, v):
    if name == "bound_shift":
        qs, bound = ap.bound_shift_inputs(q, k)
        return ap.bound_shift(qs, k, v, bound), ap.bound_shift_reference(qs, k, v, bound)
    wrapper = getattr(ap, name)
    return wrapper(q, k, v), getattr(ap, f"{name}_reference")(q, k, v)


@pytest.mark.cuda
@pytest.mark.parametrize("bh,n", [(4, 192), (2, 1024), (1, 64)])
@pytest.mark.parametrize("name", list(KERNELS))
def test_kernel_matches_plain_on_card(cuda, name, bh, n):
    q, k, v = (t.to(cuda) for t in make_qkv(bh, n, seed=bh))
    before = KERNELS[name].launches
    got, want = run_probe(name, q, k, v)
    torch.cuda.synchronize()
    assert KERNELS[name].launches == before + 1
    assert_close_rel(got.float().cpu().numpy(), want.float().cpu().numpy(), name)


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(KERNELS))
def test_kernel_takes_unaligned_and_strided_inputs_on_card(cuda, name):
    """An operand off 16-byte alignment or strided goes to the kernel as a
    contiguous copy (the TMA maps' rule)."""
    q, k, v = (t.to(cuda) for t in make_qkv(2, 192, seed=7))
    flat = torch.cat([torch.zeros(1, dtype=q.dtype, device=cuda), k.flatten()])
    k_off = flat[1:].view(k.shape)  # contiguous, base off alignment
    v_str = torch.stack([v, v], dim=-1)[..., 0]  # strided
    got, want = run_probe(name, q, k_off, v_str)
    assert_close_rel(got.float().cpu().numpy(), want.float().cpu().numpy(), name)


@pytest.mark.cuda
def test_bound_shift_kernel_matches_softmax_on_card(cuda):
    q, k, v = (t.to(cuda) for t in make_qkv(4, 512, seed=9))
    qs, bound = ap.bound_shift_inputs(q, k)
    got = ap.bound_shift(qs, k, v, bound).float()
    torch.testing.assert_close(got, ap.softmax_attention(q, k, v), atol=1e-2, rtol=0)


@pytest.mark.cuda
def test_kernel_raises_on_what_it_does_not_take(cuda):
    q = torch.zeros(1, 96, 64, device=cuda, dtype=torch.bfloat16)
    with pytest.raises(ValueError):
        ap.PROBE_MATMUL_ONLY(q, q, q)
    q = torch.zeros(1, 64, 64, device=cuda, dtype=torch.bfloat16)
    with pytest.raises(ValueError):
        ap.PROBE_BOUND_SHIFT(q, q, q)
