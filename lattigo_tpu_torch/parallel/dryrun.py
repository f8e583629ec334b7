"""The multichip dry run, and the rank programs it is made of.

Counterpart of ``__graft_entry__.py``'s ``dryrun_multichip`` and its two
helpers: the same four parts at the JAX dry run's own shapes, each rank a
process (:mod:`.launch`) and every collective written out (:mod:`.spmd`):

1. the dp × limb BGV step ``rescale(mul_relin(a, b))`` at logN 8 on
   2 × limb 40-bit limbs, a batch of 2 × dp, the output gathered;
2. the coefficient-sharded negacyclic product (:mod:`.ntt_sp`) over every
   rank, against the one-process product;
3. the limb-sharded hoisted rotations [1, 3] on the 8 × 40-bit + 2 × 45-bit
   CKKS chain, against the one-process rotations;
4. the dp-sharded bootstrap of a batch of dp ciphertexts at the JAX dry
   run's toy literal (≥ 6 bits), then two half-slot ciphertexts packed into
   one bootstrap through :func:`.spmd.bootstrap_many` (each ≥ 6 bits).

The port has no ``jitted`` bootstrap: the batch goes through ``bootstrap``
on each rank's rows. Keys and inputs are made from one seed on every rank
(their digests are compared over the world). The rank programs
(:func:`sp_rank`, :func:`bgv_step_rank`, :func:`hoisted_rank`) also take
their parameters, keys and inputs as numpy integers, for the tests against
the JAX package and the full-width phase of ``chip_smoke.py``; with
``record`` they count the four-step kernel's launches on the main path and
hold each distinct call against the plain version on its input.
"""

from __future__ import annotations

import hashlib
import time

import numpy as np
import torch

from lattigo_tpu_torch import interop
from lattigo_tpu_torch.parallel import launch, spmd
from lattigo_tpu_torch.parallel.mesh import (Mesh, gather_ciphertext, make_mesh,
                                             shard_ciphertext)
from lattigo_tpu_torch.parallel.ntt_sp import (gather_coefficients, intt_sharded,
                                               negacyclic_mul_sharded, ntt_sharded,
                                               shard_coefficients)
from lattigo_tpu_torch.ring import ntt_mxu
from lattigo_tpu_torch.ring.ring import Ring

#: the dry run's minimum bootstrap precision (bits), as the JAX package's
MIN_BITS = 6.0


# -- helpers ---------------------------------------------------------------------------

def digest(*tensors) -> str:
    """sha256 of tensors' bytes (keys held by every rank compare equal)."""
    h = hashlib.sha256()
    for t in tensors:
        if t is not None:
            h.update(t.detach().cpu().contiguous().numpy().tobytes())
    return h.hexdigest()


def keys_digest(evk) -> str:
    parts = []
    if evk.relinearization_key is not None:
        g = evk.relinearization_key.gadget.value
        parts += [g.q, g.p]
    for el in sorted(evk.galois_keys or {}):
        g = evk.galois_keys[el].gadget.value
        parts += [g.q, g.p]
    return digest(*parts)


def _check_same(mesh: Mesh, value: str, what: str) -> None:
    world = mesh.all_gather_object(value, mesh.axis_names[0])
    for axis in mesh.axis_names[1:]:
        world += mesh.all_gather_object(value, axis)
    if len(set(world)) != 1:
        raise RuntimeError(f"ranks hold different {what}")


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def timed_ms(fn, reps: int, device) -> float:
    """Mean ms of fn() over reps runs after one warm-up: CUDA events on a
    card, the host clock on the CPU."""
    fn()
    _sync(device)
    if torch.device(device).type == "cuda":
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / reps
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    return (time.perf_counter() - t0) / reps * 1e3


def recorded(fn):
    """Run fn() with the four-step kernel's launches counted (zeroed just
    before, read just after) and the first input of every distinct call
    kept: (fn's result, launches, calls)."""
    launch_fn = ntt_mxu.four_step_cuda
    calls = {}

    def recording(eng, x, limb_lo, inverse, lazy):
        key = (id(eng), tuple(x.shape), limb_lo, inverse, lazy)
        if key not in calls:
            calls[key] = (eng, x.clone(), limb_lo, inverse, lazy)
        return launch_fn(eng, x, limb_lo, inverse, lazy)

    ntt_mxu.four_step_cuda = recording
    try:
        ntt_mxu.reset_launches()
        out = fn()
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        launches = dict(ntt_mxu.LAUNCHES)
    finally:
        ntt_mxu.four_step_cuda = launch_fn
    return out, launches, calls


def hold_calls(calls) -> dict:
    """Each recorded four-step call against its plain version: the count,
    the largest |kernel − plain| and the (shape, limb offset, direction)
    of each call."""
    err, shapes = 0, []
    for eng, x, lo, inverse, lazy in calls.values():
        got = ntt_mxu.four_step_cuda(eng, x, lo, inverse, lazy)
        want = ntt_mxu.four_step_plain(eng, x, lo, inverse, lazy)
        err = max(err, int((got - want).abs().max()))
        if not torch.equal(got, want):
            raise RuntimeError(f"four-step kernel != plain at {tuple(x.shape)} "
                               f"limb_lo={lo} inverse={inverse} lazy={lazy}")
        shapes.append((tuple(x.shape), lo, "inv" if inverse else "fwd"))
    return dict(calls=len(calls), max_abs_err=err, shapes=sorted(set(shapes)))


def _peak_mib(device) -> float | None:
    if torch.device(device).type == "cuda":
        return torch.cuda.max_memory_allocated() / 2**20
    return None


# -- rank programs ---------------------------------------------------------------------

def sp_rank(device, n: int, moduli: list[int], a, b, reps: int = 0) -> dict:
    """The coefficient-sharded NTT over every rank ("sp" = world): a, b
    uint64 [..., L, N]. Forward (lazy and not), inverse of the forward
    (lazy and not) and the negacyclic product of a and b, each gathered;
    every one held against the one-process ring (lazy outputs mod q).
    Returns, on rank 0, the gathered outputs (numpy) and, with ``reps``,
    the ms of the sharded NTT and INTT and the bytes swapped and staged."""
    import torch.distributed as dist
    mesh = Mesh({"sp": dist.get_world_size()}, device)
    dev = mesh.device
    ring = Ring(n, list(moduli), device=dev)
    ta, tb = interop.to_torch(a, dev), interop.to_torch(b, dev)
    xa, xb = (shard_coefficients(t, mesh, "sp") for t in (ta, tb))
    mesh.reset_stats()
    f = ntt_sharded(ring, xa, mesh, "sp")
    f_lazy = ntt_sharded(ring, xa, mesh, "sp", lazy=True)
    fg = gather_coefficients(f, mesh, "sp")
    i_ = intt_sharded(ring, shard_coefficients(fg, mesh, "sp"), mesh, "sp")
    i_lazy = intt_sharded(ring, shard_coefficients(fg, mesh, "sp"), mesh, "sp",
                          lazy=True)
    prod = negacyclic_mul_sharded(ring, xa, xb, mesh, "sp")
    outs = {k: gather_coefficients(v, mesh, "sp") for k, v in
            dict(ntt=f, ntt_lazy=f_lazy, intt=i_, intt_lazy=i_lazy, mul=prod).items()}
    stats = dict(mesh.stats)
    q = ring.q[:ta.shape[-2]]
    want = dict(ntt=ring.ntt(ta), intt=ring.intt(outs["ntt"]),
                mul=ring.intt(ring.mul_mont(ring.mform(ring.ntt(ta)), ring.ntt(tb))))
    checks = dict(ntt=torch.equal(outs["ntt"], want["ntt"]),
                  ntt_lazy=torch.equal(outs["ntt_lazy"] % q, want["ntt"]),
                  intt=torch.equal(outs["intt"], want["intt"])
                  and torch.equal(outs["intt"], ta),
                  intt_lazy=torch.equal(outs["intt_lazy"] % q, want["intt"]),
                  mul=torch.equal(outs["mul"], want["mul"]))
    res = dict(checks=checks, stats=stats, engine=ring.ntt_engine,
               local_shape=tuple(xa.shape))
    if reps:
        res["ms"] = dict(
            ntt=timed_ms(lambda: ntt_sharded(ring, xa, mesh, "sp"), reps, dev),
            intt=timed_ms(lambda: intt_sharded(ring, f, mesh, "sp"), reps, dev),
            ntt_one=timed_ms(lambda: ring.ntt(ta), reps, dev),
            intt_one=timed_ms(lambda: ring.intt(want["ntt"]), reps, dev))
    if mesh.rank == 0:
        res["outputs"] = {k: interop.to_numpy(v) for k, v in outs.items()}
    return res


def _bgv_from_payload(literal_json, rlk_rows, dev):
    from lattigo_tpu_torch.schemes import bgv
    params = bgv.Parameters(interop.parameters_literal_from_json(literal_json), device=dev)
    return params, bgv.Evaluator(params, interop.evaluation_key_set_from_numpy(
        dev, rlk=rlk_rows))


def _bgv_step(mesh: Mesh, ev, ct1, ct2, reps: int, record: bool) -> dict:
    """The dp × limb step on the global ciphertexts ct1, ct2 (NTT, at one
    level): shard, ``rescale(mul_relin)``, gather. Rank 0 gets the output."""
    dev = mesh.device
    level = ct1.level
    sev = spmd.LimbShardedEvaluator(ev, mesh)
    a = shard_ciphertext(ct1, mesh, limb_axis=True)
    b = shard_ciphertext(ct2, mesh, limb_axis=True)

    def step():
        return sev.rescale(sev.mul_relin(a, b, level), level)

    mesh.reset_stats()
    if record:
        out, launches, calls = recorded(step)
    else:
        out, launches, calls = step(), None, {}
    step_stats = dict(mesh.stats)
    full = gather_ciphertext(out, mesh, limb_axis=True)
    res = dict(launches=launches, held=hold_calls(calls) if record else None,
               step_bytes=step_stats, output_bytes=mesh.stats["gathered"]
               - step_stats["gathered"], local_in=tuple(a.value.shape),
               local_out=tuple(out.value.shape), out_shape=tuple(full.value.shape),
               scale=full.scale, engines=sorted({r.ntt_engine for r in sev._rings.values()}))
    if reps:
        res["ms"] = timed_ms(step, reps, dev)
        res["ms_gathered"] = timed_ms(
            lambda: gather_ciphertext(step(), mesh, limb_axis=True), reps, dev)
    res["peak_mib"] = _peak_mib(dev)
    if mesh.rank == 0:
        res["output"] = interop.to_numpy(full.value)
    return res


def bgv_step_rank(device, dp: int, limb: int, literal_json: str, rlk_rows, a, b,
                  scale: int = 1, reps: int = 0, record: bool = False) -> dict:
    """The dp × limb BGV step on keys and ciphertexts given as numpy
    (uint64 gadget rows of the relinearization key; ciphertexts
    [batch, 2, L, N], NTT, at ``scale``)."""
    mesh = make_mesh(dp, limb, device=device)
    params, ev = _bgv_from_payload(literal_json, rlk_rows, mesh.device)
    ct1 = interop.ciphertext_from_numpy(a, mesh.device, scale=scale)
    ct2 = interop.ciphertext_from_numpy(b, mesh.device, scale=scale)
    kd = keys_digest(ev.evk)
    _check_same(mesh, kd, "keys")
    res = _bgv_step(mesh, ev, ct1, ct2, reps, record)
    res["keys_digest"] = kd
    return res


def _hoisted(mesh: Mesh, ev, ct, rots, reps: int, record: bool) -> dict:
    dev = mesh.device
    level = ct.level
    sev = spmd.LimbShardedEvaluator(ev, mesh)
    x = shard_ciphertext(ct, mesh, limb_axis=True, dp_axis=False)

    def run():
        return sev.rotate_columns_hoisted(x, level, rots)

    mesh.reset_stats()
    if record:
        outs, launches, calls = recorded(run)
    else:
        outs, launches, calls = run(), None, {}
    step_stats = dict(mesh.stats)
    full = {k: gather_ciphertext(v, mesh, limb_axis=True, dp_axis=False)
            for k, v in outs.items()}
    res = dict(launches=launches, held=hold_calls(calls) if record else None,
               step_bytes=step_stats, local_in=tuple(x.value.shape),
               engines=sorted({r.ntt_engine for r in sev._rings.values()}))
    if reps:
        res["ms"] = timed_ms(run, reps, dev)
    res["peak_mib"] = _peak_mib(dev)
    if mesh.rank == 0:
        res["outputs"] = {k: interop.to_numpy(v.value) for k, v in full.items()}
    return res


def hoisted_rank(device, limb: int, literal_json: str, galois_rows: dict, ct,
                 rots: list[int], reps: int = 0, record: bool = False) -> dict:
    """Limb-sharded hoisted rotations (CKKS) on keys and a ciphertext given
    as numpy: ``galois_rows`` maps each Galois element to its (q, p) gadget
    rows; ct [2, L, N] or [batch, 2, L, N], NTT. The mesh is (world /
    limb) × limb; its dp ranks replicate the work, as the JAX dry run's
    sharding does."""
    from lattigo_tpu_torch.schemes import ckks
    mesh = make_mesh(limb=limb, device=device)
    dev = mesh.device
    params = ckks.Parameters(interop.parameters_literal_from_json(literal_json),
                             device=dev)
    ev = ckks.Evaluator(params, interop.evaluation_key_set_from_numpy(
        dev, galois_keys=galois_rows))
    kd = keys_digest(ev.evk)
    _check_same(mesh, kd, "keys")
    res = _hoisted(mesh, ev, interop.ciphertext_from_numpy(ct, dev), rots, reps, record)
    res["keys_digest"] = kd
    return res


# -- the dry run -----------------------------------------------------------------------

def bgv_setup(log_n: int, n_limbs: int, device, seed: int = 0):
    """The JAX dry run's BGV set-up (``__graft_entry__._setup``): 40-bit Q
    limbs, one 45-bit P, T the first 16-bit NTT-friendly prime; keys from
    ``seed``. Returns (params, evaluator, encryptor, generator)."""
    from lattigo_tpu_torch import rlwe
    from lattigo_tpu_torch.schemes import bgv
    from lattigo_tpu_torch.utils.primes import NTTFriendlyPrimesGenerator
    t = NTTFriendlyPrimesGenerator(16, 2 << log_n).next_alternating_prime()
    params = bgv.Parameters(bgv.ParametersLiteral(
        log_n=log_n, log_q=(40,) * n_limbs, log_p=(45,), t=t), device=device)
    gen = torch.Generator(device=params.ring_q.device).manual_seed(seed)
    kg = rlwe.KeyGenerator(params)
    sk = kg.gen_secret_key(gen)
    ev = bgv.Evaluator(params, rlwe.EvaluationKeySet(kg.gen_relinearization_key(gen, sk)))
    return params, ev, rlwe.Encryptor(params, sk), gen


def hoisted_setup(device, seed: int = 3):
    """The JAX dry run's hoisted-rotation set-up: CKKS logN 8, 8 × 40-bit Q,
    2 × 45-bit P, scale 2^38, Galois keys of rotations [1, 3], one
    encryption of zero. Returns (evaluator, ciphertext, rotations)."""
    from lattigo_tpu_torch import rlwe
    from lattigo_tpu_torch.schemes import ckks
    params = ckks.Parameters(ckks.ParametersLiteral(
        log_n=8, log_q=(40,) * 8, log_p=(45,) * 2, log_default_scale=38), device=device)
    gen = torch.Generator(device=params.ring_q.device).manual_seed(seed)
    kg = rlwe.KeyGenerator(params)
    sk = kg.gen_secret_key(gen)
    rots = [1, 3]
    gks = kg.gen_galois_keys(gen, [params.galois_element(r) for r in rots], sk)
    ev = ckks.Evaluator(params, rlwe.EvaluationKeySet(galois_keys=gks))
    return ev, rlwe.Encryptor(params, sk).encrypt_zero(gen), rots


def bootstrap_setup(device, batch: int, seed: int = 0):
    """The JAX dry run's bootstrap set-up (``_dryrun_bootstrap_dp``): the
    toy literal (residual logN 8, Q (55, 45), P (60, 60), H = 32, C2S and
    S2C scales 56 and 39, no encapsulation), keys from ``seed``, a batch of
    ``batch`` encryptions of one uniform complex vector at level 0, and two
    half-slot ciphertexts with the pack tree's keys. Returns a dict."""
    from lattigo_tpu_torch import rlwe
    from lattigo_tpu_torch.circuits import bootstrapping as bts
    from lattigo_tpu_torch.circuits import bootstrapping_presets as bp
    from lattigo_tpu_torch.ring.sampling import Ternary
    from lattigo_tpu_torch.schemes import ckks
    residual = ckks.ParametersLiteral(
        log_n=8, log_q=(55, 45), log_p=(60, 60), log_default_scale=45,
        xs=Ternary(hamming_weight=32))
    lit = bp.BootstrappingLiteral(c2s_log_scales=[[56], [56]], s2c_log_scales=[[39], [39]],
                                  ephemeral_secret_weight=None)
    full, btp_params = bp.build_bootstrapping_parameters(residual, lit)
    params = ckks.Parameters(full, device=device)
    gen = torch.Generator(device=params.ring_q.device).manual_seed(seed)
    kg = rlwe.KeyGenerator(params)
    sk = kg.gen_secret_key(gen)
    rlk = kg.gen_relinearization_key(gen, sk)
    enc = ckks.Encoder(params)
    btp = bts.BootstrappingEvaluator(params, ckks.Evaluator(
        params, rlwe.EvaluationKeySet(relinearization_key=rlk)), enc, btp_params)
    log_slots = params.log_max_slots - 1
    lvls = dict(btp.galois_element_levels())
    for el, lv in btp.packing_galois_elements(log_slots).items():
        lvls[el] = max(lvls.get(el, 0), lv)
    gks = kg.gen_galois_keys(gen, sorted(lvls), sk, levels=lvls)
    btp.with_evaluator(ckks.Evaluator(params, rlwe.EvaluationKeySet(
        relinearization_key=rlk, galois_keys=gks)))
    rng = np.random.default_rng(1)
    v = rng.uniform(-1, 1, params.max_slots) + 1j * rng.uniform(-1, 1, params.max_slots)
    encryptor = rlwe.Encryptor(params, sk)
    ct = encryptor.encrypt(gen, enc.encode(v), batch=(batch,)).at_level(0)
    n_small = 1 << log_slots
    tile = params.max_slots // n_small
    vs, cts = [], []
    for _ in range(2):
        vv = rng.uniform(-1, 1, n_small) + 1j * rng.uniform(-1, 1, n_small)
        vs.append(vv)
        cts.append(encryptor.encrypt(gen, enc.encode(np.tile(vv, tile))).at_level(0))
    return dict(params=params, btp=btp, enc=enc, dec=rlwe.Decryptor(params, sk),
                evk=btp.ev.evk, ct=ct, v=v, cts=cts, vs=vs, log_slots=log_slots)


def bits(got, want) -> float:
    return float(-np.log2(np.abs(got - want).max() + 1e-300))


def mesh_checks(mesh: Mesh, ct) -> dict:
    """The mesh's contracts on a ciphertext whose batch and limbs divide
    the mesh: dp x limb != world raises; a limb axis that the limb size
    does not divide raises (as ``jax.device_put`` does); shard then gather
    is the identity."""
    out = {}
    try:
        make_mesh(mesh.shape["dp"] + 1, mesh.shape["limb"], device=mesh.device)
        out["wrong_shape_raises"] = False
    except AssertionError:
        out["wrong_shape_raises"] = True
    if mesh.shape["limb"] > 1:
        try:
            shard_ciphertext(ct.at_level(ct.level - 1), mesh, limb_axis=True)
            out["odd_limbs_raise"] = False
        except ValueError:
            out["odd_limbs_raise"] = True
    back = gather_ciphertext(shard_ciphertext(ct, mesh, limb_axis=True), mesh,
                             limb_axis=True)
    out["shard_gather_identity"] = torch.equal(back.value, ct.value)
    return out


def programs_rank(device, programs: list) -> list:
    """Several rank programs in one world: ``programs`` lists (name,
    kwargs) with name "sp", "bgv_step" or "hoisted"."""
    fns = dict(sp=sp_rank, bgv_step=bgv_step_rank, hoisted=hoisted_rank)
    return [fns[name](device, **kwargs) for name, kwargs in programs]


def dryrun_rank(device, n_devices: int) -> dict:
    """One rank of :func:`dryrun_multichip`."""
    limb = 2 if n_devices % 2 == 0 and n_devices > 1 else 1
    mesh = make_mesh(limb=limb, device=device)
    dev, dp = mesh.device, mesh.shape["dp"]
    res = dict(mesh=dict(mesh.shape), backend=mesh.backend)

    # 1. the dp x limb BGV step; limbs = 2 * limb so the limb axis divides
    params, ev, encryptor, gen = bgv_setup(8, 2 * limb, dev)
    ct1 = encryptor.encrypt_zero(gen, batch=(2 * dp,))
    ct2 = encryptor.encrypt_zero(gen, batch=(2 * dp,))
    _check_same(mesh, keys_digest(ev.evk), "keys")
    res["mesh_checks"] = mesh_checks(mesh, ct1)
    if not all(res["mesh_checks"].values()):
        raise RuntimeError(f"mesh checks failed: {res['mesh_checks']}")
    step = _bgv_step(mesh, ev, ct1, ct2, 0, False)
    want = ev.rescale(ev.mul_relin(ct1, ct2))
    if mesh.rank == 0:
        if not np.array_equal(step["output"], interop.to_numpy(want.value)):
            raise RuntimeError("dp x limb BGV step diverged from one process")
    res["step"] = {k: step[k] for k in ("out_shape", "local_in", "local_out",
                                        "step_bytes", "output_bytes")}

    # 2. the coefficient-sharded negacyclic product over every rank
    ring = params.ring_q
    rng = np.random.default_rng(0)
    moduli = np.array(ring.moduli, dtype=np.uint64)[:, None]
    a = rng.integers(0, 1 << 62, (len(ring.moduli), ring.n)).astype(np.uint64) % moduli
    b = rng.integers(0, 1 << 62, (len(ring.moduli), ring.n)).astype(np.uint64) % moduli
    sp = sp_rank(device, ring.n, ring.moduli, a, b)
    if not all(sp["checks"].values()):
        raise RuntimeError(f"sp-sharded NTT diverged from one process: {sp['checks']}")
    res["sp"] = dict(checks=sp["checks"], stats=sp["stats"])

    # 3. limb-sharded hoisted rotations, bit-exact
    hev, hct, rots = hoisted_setup(dev)
    _check_same(mesh, keys_digest(hev.evk), "keys")
    hz = _hoisted(mesh, hev, hct, rots, 0, False)
    ref = hev.rotate_columns_hoisted(hct, rots)
    if mesh.rank == 0:
        for r in rots:
            if not np.array_equal(hz["outputs"][r], interop.to_numpy(ref[r].value)):
                raise RuntimeError("limb-sharded hoisted rotation diverged "
                                   "from one process")
    res["hoisted"] = dict(step_bytes=hz["step_bytes"], local_in=hz["local_in"])

    # 4. the dp-sharded bootstrap of a batch of dp, then the packed pair
    s = bootstrap_setup(dev, dp)
    _check_same(mesh, keys_digest(s["evk"]), "keys")
    local = shard_ciphertext(s["ct"], mesh)
    out = gather_ciphertext(s["btp"].bootstrap(local), mesh)
    got = s["enc"].decode(s["dec"].decrypt(out))
    res["bootstrap_bits"] = [bits(g, s["v"]) for g in got]
    outs = spmd.bootstrap_many(s["btp"], s["cts"], mesh, log_slots=s["log_slots"])
    n_small = 1 << s["log_slots"]
    res["packed_bits"] = [bits(s["enc"].decode(s["dec"].decrypt(o))[:n_small], vv)
                          for o, vv in zip(outs, s["vs"])]
    if min(res["bootstrap_bits"] + res["packed_bits"]) < MIN_BITS:
        raise RuntimeError(f"bootstrap precision below {MIN_BITS} bits: "
                           f"{res['bootstrap_bits']}, {res['packed_bits']}")
    if mesh.rank == 0:
        res["bootstrap"] = interop.to_numpy(out.value)
        res["packed"] = [interop.to_numpy(o.value) for o in outs]
        res["out_shape"] = step["out_shape"]
    return res


def dryrun_multichip(n_devices: int, device=None, backend: str | None = None) -> dict:
    """One sharded step of each part over an n-rank world (the JAX dry
    run's shapes); raises if a part diverges from one process or a
    bootstrap falls below 6 bits. Returns rank 0's results."""
    res = launch.run(dryrun_rank, n_devices, device, n_devices, backend=backend)
    r0 = res[0]
    print(f"dryrun_multichip({n_devices}): OK, mesh={r0['mesh']} ({r0['backend']}) "
          f"+ sp={n_devices} + limb-sharded hoisted rotations "
          f"+ dp-sharded bootstrap_many, out shape={r0['out_shape']}")
    return r0
