"""The port's self test (`optical_flow_tpu_torch/utils/selftest.py`)
against the JAX package's (`optical_flow_tpu/utils/selftest.py`), on the
CPU.

Each JAX case is run with its Pallas entry points replaced by recorders
(no Pallas runs: the recorders keep the arrays the case hands the kernel
and return a stand-in), so the test sees the inputs the JAX case builds
and the XLA reference it computes.  Then:

  * the port's case list is JAX's `_cases(quick=False)` names plus
    `colorize/u8_48x200`, plus the K7, pyramid, X1 and X2 cases;
  * each shared case's `inputs()` equal the JAX case's, array for array;
  * each case's plain version, run on those inputs on the CPU, matches
    the JAX XLA reference (`core.*`, `ops/*`) at the case's tolerance;
    the iterated flow of the fused_iterate cases by the port's flow
    gate at that tolerance (>= 99.9 % of components, mean <= 1e-3 px),
    because JAX's XLA box sum drifts with the row's length.
    Where the JAX case compares two TPU kernels to the bit (tolerance 0:
    bf16 staging, store layouts, the multi-level sweep, the fused step
    against its unfused pair), the XLA reference of the same function
    stands in, at the tolerance of that kernel's other cases (the JAX
    self test's tolerance for it against XLA); K4 keeps its byte gate.

Also: the CPU self test (plain against plain, `"kernels": false`), that
the card is required unless the CPU is asked for, that a case that
raises fails the verdict and the CLI, and the pyramid case's gate and
strip EPE at a small size.
"""

import functools
import json
import os
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import optical_flow_tpu.models.farneback.core as jcore
import optical_flow_tpu.pallas.blur_solve as jbs
import optical_flow_tpu.pallas.colorize as jcz
import optical_flow_tpu.pallas.fused_iterate as jfi
import optical_flow_tpu.pallas.gauss as jga
import optical_flow_tpu.pallas.gauss_resize as jgr
import optical_flow_tpu.pallas.polyexp as jpe
import optical_flow_tpu.pallas.update_gather as jug
from optical_flow_tpu.models.farneback.params import gaussian_kernel
from optical_flow_tpu.ops.colorize import flow_to_bgr_u8
from optical_flow_tpu.ops.resize import resize_bilinear_f32
from optical_flow_tpu.utils import selftest as jselftest
from optical_flow_tpu_torch.models.farneback import core as tcore
from optical_flow_tpu_torch.utils import selftest

REPO = Path(__file__).resolve().parents[1]
JAX_NAMES = [c["name"] for c in jselftest._cases(quick=False)] + ["colorize/u8_48x200"]
PORT = {c.name: c for c in selftest._cases()}
# the tolerance of each kernel family's cases against XLA in the JAX self test
FAMILY_TOL = {"fused_iterate": (2e-3, 1e-3), "fused_blur": (2e-3, 1e-3),
              "polyexp": (2e-2, 1e-5), "gauss_resize": (1e-3, 1e-5)}
FLOW_SHARE = 0.999


class _Recorder:
    """Replaces the Pallas entry points of the JAX cases: records each
    call's arguments and returns a stand-in."""

    def __init__(self, monkeypatch):
        self.calls = []
        fake = self.fake
        for mod, name, ret in [
                (jug, "update_matrices_pallas_batched", lambda a, k: a[0]),
                (jbs, "update_flow_blur_solve_pallas", lambda a, k: a[0]),
                (jfi, "supported", lambda a, k: True),
                (jfi, "bf16_store_ok", lambda a, k: True),
                (jfi, "fused_store_geometry", lambda a, k: (1, 1)),
                (jfi, "update_flow_fused", lambda a, k: (a[2], None)),
                (jpe, "poly_exp_pallas_store",
                 lambda a, k: jnp.zeros((a[0].shape[0], 5, 1, 1), jnp.bfloat16)),
                (jpe, "poly_exp_pallas", lambda a, k: a[0]),
                (jga, "gaussian_blur_pallas", lambda a, k: a[0]),
                (jgr, "supported", lambda a, k: True),
                (jgr, "multi_supported", lambda a, k: True),
                (jgr, "gaussian_blur_resize_pallas", lambda a, k: a[0]),
                (jgr, "gaussian_blur_resize_multi", lambda a, k: [a[0]]),
                (jug, "update_matrices_store", lambda a, k: (a[0], None)),
                (jbs, "blur_solve_store", lambda a, k: a[0]),
                (jug, "fused_update_blur_store", lambda a, k: (a[0], np.zeros(1))),
                (jcz, "flow_to_bgr_planar_pallas",
                 lambda a, k: jnp.zeros((a[0].shape[0], 3) + a[0].shape[2:], jnp.uint8))]:
            monkeypatch.setattr(mod, name, fake(name, ret))
        real_poly = jcore.poly_exp
        monkeypatch.setattr(jcore, "poly_exp", fake("core.poly_exp",
                                                    lambda a, k: real_poly(*a, **k)))

    def fake(self, name, ret):
        def run(*args, **kwargs):
            self.calls.append((name, args, kwargs))
            return ret(args, kwargs)
        return run

    def first(self, name):
        return next(a for n, a, _ in self.calls if n == name)


def _np(x):
    return np.asarray(x)


def _capture(name, monkeypatch):
    """(inputs, reference, tolerance) of one JAX case: the arrays it hands
    its kernel and the XLA reference of the kernel's function."""
    rec = _Recorder(monkeypatch)
    family = name.split("/")[0]
    if name == "colorize/u8_48x200":
        jselftest._colorize_case()
        flow = _np(rec.first("flow_to_bgr_planar_pallas")[0])
        ref = np.moveaxis(_np(flow_to_bgr_u8(jnp.moveaxis(jnp.asarray(flow), 1, -1))), -1, 1)
        return {"flow": flow}, ref, None
    case = next(c for c in jselftest._cases(quick=False) if c["name"] == name)
    _, ref = case["run"]()
    tol = (case["atol"], case["rtol"])
    if family == "update_gather":
        R0, R1, flow = rec.first("update_matrices_pallas_batched")
        return {"R0": _np(R0), "R1": _np(R1), "flow": _np(flow)}, _np(ref), tol
    if family == "blur_solve":
        return {"M": _np(rec.first("update_flow_blur_solve_pallas")[0])}, _np(ref), tol
    if family == "fused_iterate":
        R0, R1, flow = rec.first("update_flow_fused")[:3]
        B = flow.shape[0]
        if "bf16" in name:
            img = _np(rec.first("poly_exp_pallas_store")[0])
            R = jcore.poly_exp(jnp.asarray(img), 5, 1.2)
            ref = jcore.update_flow(R[:B], R[B:], flow, 15, 2)
            return {"img": img, "flow": _np(flow)}, _np(ref), FAMILY_TOL[family]
        img = _np(rec.first("core.poly_exp")[0])
        return {"img": img, "flow": _np(flow)}, _np(ref), tol
    if family == "gauss":
        return {"img": _np(rec.first("gaussian_blur_pallas")[0])}, _np(ref), tol
    if family == "gauss_resize":
        if "multi" in name:
            img = _np(rec.first("gaussian_blur_resize_multi")[0])
            refs = [resize_bilinear_f32(jcore.gaussian_blur_reflect101(
                jnp.asarray(img), gaussian_kernel(ks, sg)), img.shape[2] // s,
                img.shape[1] // s).reshape(2, -1)
                for s, ks, sg in [(8, 19, 3.5), (4, 9, 1.5), (2, 3, 0.5)]]
            return {"img": img}, _np(jnp.concatenate(refs, 1)), FAMILY_TOL[family]
        img, taps, s = rec.first("gaussian_blur_resize_pallas")[:3]
        img = _np(img)
        if "bf16" in name:
            ref = resize_bilinear_f32(jcore.gaussian_blur_reflect101(jnp.asarray(img), taps),
                                      img.shape[2] // s, img.shape[1] // s)
            return {"img": img}, _np(ref), FAMILY_TOL[family]
        return {"img": img}, _np(ref), tol
    if family == "polyexp":
        if "bitwise" in name:
            call = ("poly_exp_pallas_store" if "pair" in name else "poly_exp_pallas")
            img = _np(rec.first(call)[0])
            ref = jcore.poly_exp(jcore.gaussian_blur_reflect101(
                jnp.asarray(img), gaussian_kernel(3, 0.0)), 5, 1.2)
            return {"img": img}, _np(ref), FAMILY_TOL[family]
        return {"img": _np(rec.first("poly_exp_pallas")[0])}, _np(ref), tol
    if family == "fused_blur":
        R0p, R1p, flp, H, W, ws, gaussian = rec.first("fused_update_blur_store")
        inside = (slice(None), slice(None), slice(jug.ROW_OFF, jug.ROW_OFF + H),
                  slice(jug.COL_OFF, jug.COL_OFF + W))
        R0, R1, flow = (_np(a)[inside] for a in (R0p, R1p, flp))
        ref = jcore.update_flow(jnp.asarray(R0), jnp.asarray(R1), jnp.asarray(flow),
                                ws, 1, gaussian)
        return {"R0": R0, "R1": R1, "flow": flow}, _np(ref), FAMILY_TOL[family]
    raise AssertionError(f"no capture for {name}")


@functools.lru_cache(maxsize=None)
def _captured(name):
    mp = pytest.MonkeyPatch()
    try:
        return _capture(name, mp)
    finally:
        mp.undo()


def test_case_list_is_jax_plus_k7_and_pyramid():
    names = [c.name for c in selftest._cases()]
    assert len(JAX_NAMES) == 37 and len(set(names)) == len(names)
    assert names[:len(JAX_NAMES)] == JAX_NAMES
    extra = names[len(JAX_NAMES):]
    suffixes = [n.split("/")[1] for n in JAX_NAMES if n.startswith("fused_iterate/")
                and "bf16" not in n]
    assert extra == [f"{g}/{s}" for s in suffixes for g in ("fused_poly", "fused_poly_k2k1")] \
        + ["pyramid/vertical_jump_1080x1920", "resample/upsample_x2_67x121",
           "resample/area_seed_strided_96x128", "resample/area_grow_10x40",
           "resample/halo_rows_135x240", "magnitude_sum/pairs_7_72x129"]
    # each shared case keeps the JAX tolerance as its ceiling
    for c in jselftest._cases(quick=False):
        assert (PORT[c["name"]].atol, PORT[c["name"]].rtol) == (c["atol"], c["rtol"])
    quick = [c.name for c in selftest._cases(quick=True)]
    assert quick == [c["name"] for c in jselftest._cases(quick=True)] + [
        "colorize/u8_48x200", "fused_poly/store_unaligned_70x257"]


@pytest.mark.parametrize("name", JAX_NAMES)
def test_case_inputs_equal_jax(name):
    want, _, _ = _captured(name)
    got = PORT[name].inputs()
    assert sorted(got) == sorted(want)
    for key in want:
        assert got[key].dtype == want[key].dtype, key
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)


@pytest.mark.parametrize("name", JAX_NAMES)
def test_case_plain_matches_jax_reference(name):
    inputs, ref, tol = _captured(name)
    case = PORT[name]
    out = case.plain(**{k: torch.as_tensor(np.array(v)) for k, v in inputs.items()}).numpy()
    assert out.shape == ref.shape
    if tol is None:         # K4's byte gate
        diff = np.abs(out.astype(np.int16) - ref.astype(np.int16))
        assert diff.max() <= selftest.BYTE_MAX
        assert (diff > 0).mean() <= selftest.BYTE_SHARE
        return
    atol, rtol = tol
    if name.startswith("fused_iterate/"):
        # iterated flow: the share gate (see the module docstring and
        # test_port_box_sum_is_nearer_float64_than_jax_at_8k)
        d = np.abs(out - ref)
        assert (d <= atol + rtol * np.abs(ref)).mean() >= FLOW_SHARE
        assert d.mean() <= 1e-3
        return
    np.testing.assert_allclose(out, ref, atol=atol, rtol=rtol)


def test_port_box_sum_is_nearer_float64_than_jax_at_8k():
    """Why the iterated cases take the share gate: JAX's XLA box sum is a
    difference of prefix sums along the row, whose error grows with the
    row's length; the port's plain version sums each window directly.  On
    the first step of fused_iterate/chunked_8k_48x7680 (width 7680) the
    port stays within 1e-5 px of a float64 evaluation of the same M; JAX
    is off by about 1e-4, and two iterations carry that to a few hundred
    components past 2e-3 + 1e-3 |ref|."""
    inputs, _, _ = _captured("fused_iterate/chunked_8k_48x7680")
    img, flow = torch.as_tensor(np.array(inputs["img"])), torch.as_tensor(np.array(inputs["flow"]))
    R = tcore.poly_exp(img, 5, 1.2)
    M = tcore.update_matrices(R[:1], R[1:], flow)
    port = tcore.blur_solve(M, 15, False).numpy()
    jax = _np(jcore.update_flow(jnp.asarray(R[:1].numpy()), jnp.asarray(R[1:].numpy()),
                                jnp.asarray(inputs["flow"]), 15, 1))
    M64 = np.pad(M.double().numpy(), [(0, 0), (0, 0), (7, 7), (7, 7)], mode="edge")
    S = sum(M64[..., i:i + 48, j:j + 7680] for i in range(15) for j in range(15)) / 225
    g11, g12, g22, h1, h2 = (S[:, i] for i in range(5))
    idet = 1.0 / (g11 * g22 - g12 * g12 + 1e-3)
    ref = np.stack([(g11 * h2 - g12 * h1) * idet, (g22 * h1 - g12 * h2) * idet], 1)
    port_err, jax_err = np.abs(port - ref).max(), np.abs(jax - ref).max()
    assert port_err < 1e-5 < jax_err


def test_k7_cases_share_the_iterate_inputs():
    """The K7 cases draw fused_iterate's inputs, spills included."""
    for name, case in PORT.items():
        if name.startswith("fused_poly"):
            twin = PORT["fused_iterate/" + name.split("/")[1]].inputs()
            got = case.inputs()
            for key in twin:
                np.testing.assert_array_equal(got[key], twin[key])
    assert (PORT["fused_poly/store_spill"].inputs()["flow"][:, 1, 30:34, 100:200] == 45).all()


def test_cpu_selftest_is_plain_against_plain():
    v = selftest.run_selftest(device="cpu", quick=True)
    assert v["ok"] and v["n_failed"] == 0 and v["n_cases"] == 9
    assert v["kernels"] is False and v["device"] == "cpu"
    assert set(v["max_abs_diff"]) == {"K1", "K2", "K3", "K4", "K5a", "K5b", "K6", "K7"}


def test_a_case_that_raises_fails_the_verdict(monkeypatch):
    real = selftest._cases

    def broken(quick=False):
        cases = real(quick)

        def boom(**t):
            raise RuntimeError("injected")
        cases[0] = selftest.Case(cases[0].name, cases[0].kernel, 0.0, 0.0,
                                 cases[0].inputs, boom, boom)
        return cases

    monkeypatch.setattr(selftest, "_cases", broken)
    v = selftest.run_selftest(device="cpu", quick=True)
    assert not v["ok"] and v["n_failed"] == 1
    assert "injected" in v["cases"][0]["error"]
    assert selftest.main(["--device", "cpu", "--quick"]) == 1


def _cli(*args, **env):
    base = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    return subprocess.run([sys.executable, "-m", "optical_flow_tpu_torch.utils.selftest",
                           *args], cwd=REPO, capture_output=True, text=True, timeout=300,
                          env={**base, "PYTHONPATH": str(REPO), **env})


def test_cli_prints_one_verdict_on_the_cpu():
    out = _cli("--device", "cpu", "--quick")
    assert out.returncode == 0, out.stderr[-2000:]
    v = json.loads(out.stdout.strip().splitlines()[-1])
    assert v["ok"] and v["kernels"] is False


def test_selftest_needs_a_card_unless_asked_for_the_cpu():
    out = _cli("--quick", CUDA_VISIBLE_DEVICES="")
    assert out.returncode != 0
    assert "no CUDA card" in out.stderr


def test_pyramid_case_gate_and_strip_epe_at_a_small_size():
    """The pyramid case's comparison at 216x384 on the CPU: the kernel
    route is the plain path here, so the gate passes with nothing off,
    and the strip EPE reads the jump rows against the static rest."""
    case = selftest.Case("pyramid/small", "pyramid", selftest.FLOW_ATOL, selftest.FLOW_RTOL,
                         lambda: selftest._jump_inputs(216, 384), PORT[
                             "pyramid/vertical_jump_1080x1920"].plain, None, gate="flow")
    r = selftest.run_case(case, torch.device("cpu"))
    assert r["ok"] and r["share_within"] == 1.0 and r["mean_abs_diff"] == 0.0
    assert 0 <= r["epe_outside"] < r["epe_in_strips"]
    flow = torch.zeros((1, 216, 384, 2))
    flow[:, 79:96, :, 1] = 40.0          # the first strip's rows, exact
    e = selftest.strip_epe(flow)
    assert e["epe_outside"] == 0.0 and e["epe_in_strips"] > 0
