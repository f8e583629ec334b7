"""Per-stage bootstrap error audit: the counterpart of the JAX package's
``diag_bootstrap_stages.py``, with its arguments, lines and figures.

    python3 diag_bootstrap_stages_torch.py [log_n] [preset] [--device cpu]

One bootstrap of a published preset (at a reduced ring degree when
``log_n`` is given) runs through
:meth:`~lattigo_tpu_torch.circuits.bootstrapping.BootstrappingEvaluator.bootstrap`
with its ``on_stage`` hook, and each stage's output is decrypted and held
against the exact integer payload it should carry:

* the encapsulation noise: the level-0 payload after ModUp (and the
  dense → sparse → dense switches around it) against the payload before;
* the post-C2S residual against the exact full-chain payload M = m + q0·I,
  after a least-squares scalar fit;
* the EvalMod error, split into the ladder's RLWE noise (measured output
  against the pure-math EvalMod of the measured input), the polynomial
  approximation error (pure math against m/q0) and their sum, each with a
  DC-bias probe (its mean);
* the error S2C adds, in coefficients and in slots, with the worst slots;
* the decomposition of the end-to-end error, err_total = err_pre +
  err_s2c, where err_pre carries everything through EvalMod (exact by
  construction: err_s2c is the rest), and the input ciphertext's own
  noise (err_in) as the floor;
* beyond the JAX script: err_pre split further, slot by slot, into the
  payload's own part, EvalMod's approximation and its ladder noise, and
  the tail (the slots 4 bits or more under the mean) attributed to the
  largest of these parts and err_s2c (:func:`tail_split`).

:func:`audit` returns every printed figure in a dict (and the lines, and
the stage ciphertexts it saw), so that tests and ``chip_smoke.py`` check
them. The exact payloads go through the host big-int CRT
(:meth:`~lattigo_tpu_torch.ring.ring.Ring.to_int_coeffs`), one polynomial
a stage. Only the standard circuit order is audited: in the slim order
EvalMod's output is the result and there is no S2C stage to split.
"""

from __future__ import annotations

import argparse
import sys
import time
from fractions import Fraction

import numpy as np
from numpy.polynomial import chebyshev

from lattigo_tpu_torch.device import resolve_device


def _log2(x) -> float:
    return float(np.log2(x))


def _rms(x) -> float:
    return float(np.sqrt((np.abs(x) ** 2).mean()))


def _math_mod1(mod1, u):
    """EvalMod in f64 on the measured C2S output u (already mapped to
    y/K): the Chebyshev polynomial, then the double-angle ladder."""
    cf = np.array([float(c) for c in mod1._poly.coeffs])
    c = chebyshev.chebval(u, cf)
    si = mod1._sqrt2pi
    for _ in range(mod1._r):
        c = 2 * c * c - si * si
        si = si * si
    return c


def audit(btp, keys, ct, sk, slots, name: str = "") -> dict:
    """Bootstrap ``ct`` (an unbatched encryption of ``slots`` under ``sk``)
    with ``btp`` and ``keys``, and audit each stage (see the module's
    docstring). Returns the figures, ``lines`` (the JAX script's lines,
    prefixed ``logN=<n> <name>:``) and ``stages`` (the hook's ciphertexts)."""
    from lattigo_tpu_torch.circuits.bootstrapping import MODUP_THEN_ENCODE
    from lattigo_tpu_torch.circuits.dft import bit_reversal_permutation
    from lattigo_tpu_torch.rlwe.encryption import Decryptor

    if btp.btp.circuit_order != MODUP_THEN_ENCODE:
        raise ValueError(
            f"the audit splits the {MODUP_THEN_ENCODE!r} order; this evaluator runs "
            f"{btp.btp.circuit_order!r}, whose EvalMod output is the result")
    if ct.value.dim() != 3:
        raise ValueError(f"the audit takes one ciphertext, not a batch: value "
                         f"shape {tuple(ct.value.shape)}")
    params, enc = btp.params, btp.encoder
    ring = params.ring_q
    dec = Decryptor(params, sk)
    v = np.asarray(slots, dtype=np.complex128)
    n = params.max_slots
    pre = f"logN={params.log_n} {name}:"
    lines: list[str] = []
    res: dict = dict(log_n=params.log_n, preset=name, slots=n, lines=lines)

    def say(text: str) -> None:
        lines.append(f"{pre} {text}")

    def int_coeffs(c) -> list[int]:
        pt = dec.decrypt(c, out_ntt=False)
        return ring.to_int_coeffs(pt.value, c.level, centered=True)

    def decode(c) -> np.ndarray:
        return enc.decode(dec.decrypt(c))

    # the exact level-0 payload, input RLWE noise included: the signal the
    # pipeline must keep
    ct0 = btp.scale_down(ct)
    q0 = params.q_moduli[0]
    m_int = np.array([float(x) for x in int_coeffs(ct0)])
    delta0 = Fraction(ct0.scale)

    t0 = time.perf_counter()
    stages: dict = {}
    btp.bootstrap(ct, keys, on_stage=lambda stage, c: stages.setdefault(stage, c))
    res["stages"] = stages
    res["bootstrap_s"] = time.perf_counter() - t0
    up, ct_re, ct_im = stages["pre"], stages["c2s re"], stages["c2s im"]
    m_re, m_im, out = stages["mod1 re"], stages["mod1 im"], stages["out"]

    # post-C2S: the exact full-chain payload M = m + q0·I, divided back by
    # the pre stage's exact integer amplification round(2^evalmod_scale/q0)
    perm = bit_reversal_permutation(n)
    s_up = round(Fraction(up.scale) / Fraction(q0))
    m_full = np.array([float((x + (s_up >> 1)) // s_up) for x in int_coeffs(up)])

    # encapsulation noise: the dense → sparse and sparse → dense switches
    # around ModUp add eps to the level-0 payload (M mod q0 = m_int + eps);
    # the later audits take M as ground truth and cannot see it
    m_after = ((m_full % q0) + q0 / 2) % q0 - q0 / 2
    eps = m_after - m_int
    ratio = float(Fraction(q0) / delta0)
    eps_rms = float(np.sqrt((eps ** 2).mean()))
    eps_msg = eps_rms * np.sqrt(2 * n) * ratio / q0
    res["encapsulation"] = dict(rms=eps_rms, max=float(np.abs(eps).max()),
                                msg_log2=_log2(max(eps_msg, 1e-300)))
    say(f"encapsulation noise rms {eps_rms:.3g} max {np.abs(eps).max():.3g} coeff "
        f"units -> ~2^{np.log2(max(eps_msg, 1e-300)):.1f} message units (rms-based)")

    c2s_re, c2s_im = decode(ct_re).real, decode(ct_im).real
    res["post_c2s"] = {}
    for tag, got_h, exp_h in (("re", c2s_re, m_full[:n][perm] / q0),
                              ("im", c2s_im, m_full[n:][perm] / q0)):
        cfit = np.dot(exp_h, got_h) / np.dot(exp_h, exp_h)
        r = np.abs(got_h - cfit * exp_h) / abs(cfit)   # payload/q0 units
        res["post_c2s"][tag] = dict(fit=float(cfit), rms_log2=_log2(_rms(r)),
                                    max_log2=_log2(r.max()),
                                    payload_rms_log2=_log2(_rms(exp_h)))
        say(f"post-C2S {tag}: fit c={cfit:.6g} residual rms 2^{np.log2(_rms(r)):.1f} "
            f"max 2^{np.log2(r.max()):.1f} (payload/q0 units, |payload| rms "
            f"2^{np.log2(_rms(exp_h)):.1f})")

    # post-EvalMod slots hold m_k/q0 (first half) and m_{k+n}/q0,
    # bit-reversed; both halves should be real, and any imaginary part is
    # error that the re + i·im recombination folds into the output
    dec_re, dec_im = decode(m_re), decode(m_im)
    imag_err = max(np.abs(dec_re.imag).max(), np.abs(dec_im.imag).max())
    res["post_evalmod_imag"] = dict(log2=_log2(imag_err),
                                    bits=-_log2(imag_err * ratio))
    say(f"post-EvalMod IMAG component = 2^{np.log2(imag_err):.1f} (m/q0 units) -> "
        f"{-np.log2(imag_err * ratio):.1f} bits in message units")
    got_re, got_im = dec_re.real, dec_im.real
    exp_re, exp_im = m_int[:n] / q0, m_int[n:] / q0

    # the pure-math EvalMod of the measured C2S outputs splits the
    # post-EvalMod error into the ladder's RLWE noise (got − model) and the
    # polynomial approximation error (model − m/q0); a |mean| far above
    # rms/√n is a DC bias, which S2C and decode put on the slots whose
    # embedding root is closest to 1 (gain ≈ 1.27·n): the worst-slot tail
    model = _math_mod1(btp.mod1, np.stack([c2s_re, c2s_im]))
    gotm = np.stack([got_re, got_im])
    expm = np.stack([exp_re[perm], exp_im[perm]])
    res["evalmod_split"] = {}
    for key, label, d in (("ladder", "ladder RLWE (got-model)", gotm - model),
                          ("approx", "approx (model-exp)", model - expm),
                          ("total", "total (got-exp)", gotm - expm)):
        a = np.abs(d)
        mean = float(d.mean())
        res["evalmod_split"][key] = dict(rms_log2=_log2(_rms(a)), max_log2=_log2(a.max()),
                                         mean=mean, mean_log2=_log2(abs(mean) + 1e-300))
        say(f"EvalMod split {label}: rms 2^{np.log2(_rms(a)):.1f} max "
            f"2^{np.log2(a.max()):.1f} mean 2^{np.log2(abs(mean) + 1e-300):.1f} "
            "(m/q0 units)")
    best = None
    for tag, pr in (("bitrev", perm), ("identity", np.arange(n))):
        e = max(np.abs(got_re - exp_re[pr]).max(), np.abs(got_im - exp_im[pr]).max())
        if best is None or e < best[1]:
            best = (tag, e)
    res["post_evalmod"] = dict(order=best[0], log2=_log2(best[1]),
                               bits=-_log2(best[1] * ratio))
    say(f"post-EvalMod err ({best[0]}) = 2^{np.log2(best[1]):.1f} (m/q0 units) -> "
        f"{-np.log2(best[1] * ratio):.1f} bits in message units")

    # raw S2C (before the q0 relabel, which the hook's "out" already
    # carries: its scale divided back by Δ₀/q0, metadata only). S2C inverts
    # the C2S packing, so its output coefficients are the measured slot
    # values: any difference is error S2C itself added, given its input
    raw_scale = Fraction(out.scale) * Fraction(q0) / delta0
    got_c = np.array([float(x) for x in int_coeffs(out)])
    sc = float(raw_scale)
    pr = perm if best[0] == "bitrev" else np.arange(n)
    exp_c = np.zeros(2 * n)
    exp_c[pr] = sc * got_re
    exp_c[pr + n] = sc * got_im
    dc = got_c - exp_c
    res["raw_s2c"] = dict(max=float(np.abs(dc).max()), rms=_rms(dc), scale_log2=_log2(sc),
                          slot_log2=_log2(np.abs(dc).max() * np.sqrt(n) / sc))
    say(f"raw-S2C added coeff err max={np.abs(dc).max():.3g} rms={_rms(dc):.3g} "
        f"(scale 2^{np.log2(sc):.1f}) -> slot units "
        f"~2^{np.log2(np.abs(dc).max() * np.sqrt(n) / sc):.1f}")

    # the S2C-added error in slots, in final message units: a max far
    # above rms·√(ln n) is coherent (a few slots), which an rms audit of
    # the coefficients cannot see
    scale_final = sc * float(delta0 / Fraction(q0))
    err_s2c = enc.coeffs_to_slots(dc) / scale_final
    mag = np.abs(err_s2c)
    top = np.argsort(mag)[::-1][:6]
    res["s2c_slot"] = dict(rms_log2=_log2(_rms(mag)), max_log2=_log2(mag.max()),
                           max=float(mag.max()), top=top.tolist(),
                           mags=[float(f"{mag[t]:.3g}") for t in top])
    say(f"S2C-added SLOT err (msg units): rms 2^{np.log2(_rms(mag)):.1f} max "
        f"2^{np.log2(mag.max()):.1f} at slots {top.tolist()} "
        f"(mags {[float(f'{mag[t]:.3g}') for t in top]})")

    # the exact linear decomposition of the final error: err_pre carries
    # everything through EvalMod, err_s2c (above) what S2C added, so their
    # sum is the end-to-end error by construction; err_in is the input
    # ciphertext's own noise, the floor no pipeline can beat
    err_pre = enc.coeffs_to_slots(exp_c) / scale_final - v
    err_in = enc.coeffs_to_slots(m_int) / float(delta0) - v
    for key, tag, e in (("err_in", "err_in (input ct noise)", err_in),
                        ("err_pre", "err_pre (everything thru EvalMod)", err_pre)):
        m_ = np.abs(e)
        res[key] = dict(rms_log2=_log2(_rms(m_)), max_log2=_log2(m_.max()))
        say(f"{tag}: rms 2^{np.log2(_rms(m_)):.1f} max 2^{np.log2(m_.max()):.1f}")

    # the worst slots of err_pre, and its fit against data-dependent
    # intermodulation terms (EvalMod's error is a deterministic function of
    # the coefficients): a large drop on a term means the tail is that
    # product, not noise
    topp = np.argsort(np.abs(err_pre))[::-1][:6]
    res["err_pre_top"] = dict(top=topp.tolist(),
                              mags=[float(f"{abs(err_pre[t]):.3g}") for t in topp])
    say(f"err_pre top slots {topp.tolist()} "
        f"(mags {[float(f'{abs(err_pre[t]):.3g}') for t in topp]})")
    basis = {"v2": v * v, "cv2": np.conj(v) ** 2, "av2v": np.abs(v) ** 2 * v,
             "v3": v ** 3, "one": np.ones_like(v)}
    res["err_pre_fits"] = {}
    for nm, bv in basis.items():
        c = np.vdot(bv, err_pre) / np.vdot(bv, bv)
        rest = err_pre - c * bv
        drop = np.sqrt((np.abs(err_pre) ** 2).mean()
                       / max((np.abs(rest) ** 2).mean(), 1e-300))
        if drop > 1.05:
            res["err_pre_fits"][nm] = dict(c_log2=_log2(abs(c) + 1e-300), drop=float(drop),
                                           max_after_log2=_log2(np.abs(rest).max()))
            say(f"err_pre ~ {nm}: |c|=2^{np.log2(abs(c) + 1e-300):.1f} rms drop "
                f"x{drop:.2f} max-after 2^{np.log2(np.abs(rest).max()):.1f}")

    # the decoded output: the relabeled "out" decodes from the same
    # integers (decode divides them by its scale, then the same FFT)
    got = enc.coeffs_to_slots(got_c / float(out.scale))
    errs = np.abs(got - v)
    err = errs.max()
    res["end_to_end_bits"] = -_log2(err)
    res["end_to_end_mean_bits"] = float(np.mean(-np.log2(np.maximum(errs, 2.0 ** -60))))
    say(f"end-to-end {-np.log2(err):.1f} bits")

    # is the final error a systematic scalar (err ∝ v, a scale-label
    # mismatch) rather than noise? fit got ≈ c·v and report the residual
    d = got - v
    c = np.vdot(v, got).real / np.vdot(v, v).real
    rest = np.abs(got - c * v).max()
    corr = abs(np.vdot(v, d)) / (np.linalg.norm(v) * np.linalg.norm(d))
    res["scalar_fit"] = dict(c_minus_1=float(c - 1), residual_bits=-_log2(rest),
                             corr=float(corr))
    say(f"scalar fit c-1={c - 1:.3e} -> residual {-np.log2(rest):.1f} bits (vs "
        f"{-np.log2(err):.1f} raw); err-vs-v corr={corr:.3f}")
    res["got"] = got

    # the tail: slots 4 bits or more under the mean. err_pre splits
    # exactly (it is linear in the S2C input) into the payload's own part
    # (the input noise, when the order is bit-reversed), EvalMod's
    # approximation (model − m/q0) and its ladder noise (got − model);
    # with err_s2c these four sum to each slot's error
    def through_s2c(part):
        c = np.zeros(2 * n)
        c[pr], c[pr + n] = sc * part[0], sc * part[1]
        return enc.coeffs_to_slots(c) / scale_final

    parts = {"input": through_s2c(expm) - v, "approx": through_s2c(model - expm),
             "ladder": through_s2c(gotm - model), "s2c": err_s2c}
    res["parts"] = parts
    res["tail"] = tail_split(errs, res["end_to_end_mean_bits"], parts)
    return res


def tail_split(errs, mean_bits: float, parts: dict) -> dict:
    """The slots whose error ``errs`` sits 4 bits or more under the mean
    precision ``mean_bits``, and how the error ``parts`` (arrays of the
    same slots, as :func:`audit`'s ``parts``) share them: for each part the
    slots where it is the largest and its largest magnitude there."""
    tail = np.flatnonzero(np.asarray(errs) >= 2.0 ** (4 - mean_bits))
    mags = np.stack([np.abs(np.asarray(p)[tail]) for p in parts.values()])
    largest = np.argmax(mags, axis=0)
    return dict(slots=tail.tolist(), count=int(tail.size),
                max_log2={k: _log2(m.max()) if tail.size else None
                          for k, m in zip(parts, mags)},
                largest={k: int((largest == i).sum()) for i, k in enumerate(parts)})


def run(log_n: int = 9, preset: str = "N15QP768_H192_H32", device=None) -> dict:
    """Set up ``preset`` at ``log_n`` as the JAX script does (keys from
    seed 0, slots from numpy's seed 1, the input at the minimum input
    level; :func:`~lattigo_tpu_torch.circuits.bootstrapping_presets
    .prepare_recipe`) and :func:`audit` one bootstrap."""
    from lattigo_tpu_torch.circuits import bootstrapping_presets as bp

    device = resolve_device(device)
    r = bp.prepare_recipe(getattr(bp, preset), log_n=log_n, seed=0, data_seed=1,
                          device=device)
    return audit(r["evaluator"], r["keys"], r["ct"], r["sk"], r["slots"], preset)


def main(argv=None) -> int:
    """``diag_bootstrap_stages.py``'s command line, plus ``--device``."""
    ap = argparse.ArgumentParser(description="Per-stage bootstrap error audit.")
    ap.add_argument("log_n", nargs="?", type=int, default=9)
    ap.add_argument("preset", nargs="?", default="N15QP768_H192_H32")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card; 'cpu' to run there)")
    a = ap.parse_args(argv)
    t0 = time.perf_counter()
    res = run(a.log_n, a.preset, a.device)
    print(f"[{time.perf_counter() - t0:.0f}s] set-up, bootstrap ({res['bootstrap_s']:.1f}s) "
          "and audit done", file=sys.stderr)
    for line in res["lines"]:
        print(line, flush=True)
    t = res["tail"]
    print(f"tail: {t['count']} slots 4 bits or more under the mean "
          f"({res['end_to_end_mean_bits']:.2f} bits); the largest part there: "
          f"{t['largest']}; max log2 of each part there: {t['max_log2']}",
          file=sys.stderr)
    return 0
