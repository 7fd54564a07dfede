"""PyTorch port, the non-equilibrium 9-species chemistry on block-sparse
L-level AMR (core/step_amr.py::SparseMLModel.make_noneq_step) against the
JAX package's on the same NumPy inputs, on the CPU, in float64.

The state: the JAX tests' clustered 8^3 base with two refined levels
(tests/test_amr_sparse.py's TestSparseNoneq grid, seed 23), each level in
the port's ionization equilibrium, synced, in blocks of 8; angular level
1, one step of 2 Myr and 20 substeps in mode 9, and in mode 8 with three
sources at maxPixelLevel 3 (the StellarContext built noneq=True): the
fields HI, HeI, HeII, Jmean and tgas and every species on every level's
covered cells within 1e-9 of each one's peak of the JAX package's step
(HeIII of the helium nuclei's peak: in mode 8 its own peak is ~1e-10 of
the helium, and the packages' networks differ at up to ~1e-8 of it there,
on the dense L-level step as on this one), the ray diagnostics too; the
padding blocks zero in the fields and the species; refined parents hold
their children's average species; the port's dense MultiLevelModel noneq
step from the same state gives the same values on covered cells (1e-9).  A block-sparse snapshot with each
level's species (`species{l}_*`, block-shaped on refined levels) written
by either package is read by the other's read_species bit for bit."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import radiativetransfer_tpu_torch as rt
from radiativetransfer_tpu.core import amr as jamr
from radiativetransfer_tpu.core import amr_sparse as jas
from radiativetransfer_tpu.core import chemistry_noneq as jcn
from radiativetransfer_tpu.core import rays as jrays
from radiativetransfer_tpu.core import state as jstate
from radiativetransfer_tpu.core import step as jstep
from radiativetransfer_tpu.core import step_amr as jstep_amr
from radiativetransfer_tpu.io import snapshot as jsnap
from radiativetransfer_tpu.tables import stellar as jstellar
from radiativetransfer_tpu_torch.config import (
    MODE_BOTH_STELLAR_UVB_TRANSFER,
    MODE_UVB_TRANSFER_ONLY,
    RunConfig,
)
from radiativetransfer_tpu_torch.constants import KPC, MYR
from radiativetransfer_tpu_torch.core import amr as tamr
from radiativetransfer_tpu_torch.core import amr_sparse as tas
from radiativetransfer_tpu_torch.core import chemistry_noneq as tcn
from radiativetransfer_tpu_torch.core import rays as trays
from radiativetransfer_tpu_torch.core import step_amr as tstep_amr
from radiativetransfer_tpu_torch.io import snapshot as tsnap
from radiativetransfer_tpu_torch.tables import stellar as tstellar
from test_torch_amr_sparse import clustered_ml, jax_sparse_np, port_ml
from test_torch_host import jax_compile_cache

N, L, BE = 8, 3, 8
BOX = 200.0 * KPC
F64 = torch.float64
SPECIES = tcn.SPECIES + ("eint",)
FIELDS = ("HI", "HeI", "HeII", "Jmean", "tgas")
KW = dict(n_substeps=20, evolve_energy=False)


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread: the eager network is ~80k small CPU ops a
    level and step (module-scoped, so that the fixtures run pinned too)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module", autouse=True)
def _jax_cache(tmp_path_factory):
    """The JAX package's compiles shared by the port's parity modules of
    this test process (test_torch_host.jax_compile_cache)."""
    with jax_compile_cache(tmp_path_factory.getbasetemp() / "jax_cache"):
        yield


def _cfg(mode):
    return RunConfig(mode=mode, current_redshift=6.55, n_angular_level=1,
                     reionization_model=10, grid="t")


def models(mode):
    """(the JAX RTModel, the port's), float64."""
    return (jstep.RTModel.setup(_cfg(mode), jstate.GridGeometry(N, N, N, BOX),
                                dtype=jnp.float64),
            rt.RTModel.setup(_cfg(mode), rt.GridGeometry(N, N, N, BOX), F64,
                             "cpu"))


def states(trt):
    """(JAX SparseMLState, port SparseMLState, port dense
    MultiLevelState): the module's grid, each level in the port's
    equilibrium, synced; the JAX state built from the port's arrays."""
    ml, _ = clustered_ml(N, seed=23, scale=5e-4)
    tml = port_ml(ml)
    tml = tamr.sync_restriction_multi(tamr.MultiLevelState(
        levels=tuple(trt.initialize_equilibrium(lv) for lv in tml.levels),
        refined=tml.refined))
    jml = jamr.MultiLevelState(
        levels=tuple(jstate.FieldState(**{
            k: None if v is None else jnp.asarray(v)
            for k, v in lv.to_numpy().items()}) for lv in tml.levels),
        refined=tuple(jnp.asarray(r.numpy()) for r in tml.refined))
    jsp = jas.sparse_from_dense(jml, be=BE)
    tsp = tas.SparseMLState.from_numpy(jax_sparse_np(jsp), dtype=F64,
                                       device="cpu")
    return jsp, tsp, tml


def jax_species(model, jsp):
    """The JAX package's block-sparse species (its CLI's start: the
    padding blocks zeroed)."""
    out = [jcn.species_from_field_state(jsp.base)]
    for ell, lv in enumerate(jsp.levels, start=1):
        out.append(model._zero_pads_tree(jcn.species_from_field_state(
            lv.fields), model._pad_mask(lv, ell)))
    return tuple(out)


def contexts(jrt, trt, n_src=3):
    pos = np.random.default_rng(7).uniform(0.3, 0.7, (n_src, 3))
    kw = dict(position=pos, weight=np.ones(n_src),
              table_idx=np.zeros(n_src, np.int32))
    jc = jstep.StellarContext.build(
        jstellar.blackbody_population(), jrays.SourceBatch(**kw), jrt.geom,
        10.0 * MYR, metal_coefs=[(0, 0.0)], max_pixel_level=3, noneq=True)
    tc = rt.StellarContext.build(
        tstellar.blackbody_population(), trays.SourceBatch(**kw), trt.geom,
        10.0 * MYR, metal_coefs=[(0, 0.0)], max_pixel_level=3, noneq=True,
        dtype=F64, device="cpu")
    return jc, tc


@pytest.fixture(scope="module")
def steps():
    """{mode: {trt, tc (the port's RTModel and StellarContext or None),
    tsm (its SparseMLModel), jsp, tsp, tml (the JAX and port states, the
    port's dense one), species (the port's before), t_out, j_out (each
    package's step output)}}."""
    out = {}
    for mode in (MODE_UVB_TRANSFER_ONLY, MODE_BOTH_STELLAR_UVB_TRANSFER):
        jrt, trt = models(mode)
        jsp, tsp, tml = states(trt)
        jsm = jstep_amr.SparseMLModel.setup(jrt, L)
        tsm = tstep_amr.SparseMLModel.setup(trt, L)
        jc = tc = None
        if mode == MODE_BOTH_STELLAR_UVB_TRANSFER:
            jc, tc = contexts(jrt, trt)
        species = tsm.initial_species(tsp)
        j_out = jsm.make_noneq_step(2.0 * MYR, jc, **KW)(
            jsp, jax_species(jsm, jsp))
        t_out = tsm.make_noneq_step(2.0 * MYR, tc, **KW)(tsp, species)
        out[mode] = dict(trt=trt, tc=tc, tsm=tsm, jsp=jsp, tsp=tsp, tml=tml,
                         species=species, t_out=t_out, j_out=j_out)
    return out


def _pairs(t_state, t_species, j_state, j_species):
    """(level, name, port values, JAX values, the scale of their
    difference: the JAX values' peak, the helium nuclei's for HeIII) on
    every level's covered cells."""
    t_f = [t_state.base] + [lv.fields for lv in t_state.levels]
    j_f = [j_state.base] + [lv.fields for lv in j_state.levels]
    for ell in range(L):
        cov = (np.ones((N,) * 3, bool) if ell == 0
               else t_state.levels[ell - 1].cover.numpy())
        for k in FIELDS:
            b = np.asarray(getattr(j_f[ell], k))[..., cov]
            yield (ell, k, getattr(t_f[ell], k).numpy()[..., cov], b,
                   float(np.abs(b).max()))
        helium = float(np.asarray(j_species[ell].HeI + j_species[ell].HeII
                                  + j_species[ell].HeIII)[cov].max())
        for k in SPECIES:
            b = np.asarray(getattr(j_species[ell], k))[cov]
            yield (ell, k, getattr(t_species[ell], k).numpy()[cov], b,
                   helium if k == "HeIII" else float(np.abs(b).max()))


@pytest.mark.parametrize("mode", [MODE_UVB_TRANSFER_ONLY,
                                  MODE_BOTH_STELLAR_UVB_TRANSFER])
def test_noneq_sparse_step_matches_jax(steps, mode):
    r = steps[mode]
    tc, tsm, tsp, t_out, j_out = (r[k] for k in ("tc", "tsm", "tsp", "t_out",
                                                "j_out"))
    assert len(t_out) == len(j_out) == (3 if tc is not None else 2)
    assert isinstance(t_out[1], tuple) and len(t_out[1]) == L
    for ell, k, a, b, scale in _pairs(t_out[0], t_out[1], j_out[0],
                                      j_out[1]):
        assert np.abs(b).max() > 0.0, (ell, k)
        assert np.abs(a - b).max() <= 1e-9 * scale, (ell, k, scale)
    if tc is not None:
        for f in dataclasses.fields(j_out[2]):
            a, b = getattr(t_out[2], f.name).numpy(), np.asarray(
                getattr(j_out[2], f.name))
            assert np.abs(a - b).max() <= 1e-9 * np.abs(b).max(), f.name
        # the k27..k31 deposits reach every level
        _, rfs, _ = tsm.trace(tsm._zero_rates(tsp), tc, "quadrature_noneq")
        assert all(float(rf.krate31.max()) > 0.0 for rf in rfs)
    assert tsm.neutral_fraction(t_out[0]) == pytest.approx(
        jstep_amr.SparseMLModel.setup(models(mode)[0], L).neutral_fraction(
            j_out[0]), rel=1e-9)


@pytest.mark.parametrize("mode", [MODE_UVB_TRANSFER_ONLY,
                                  MODE_BOTH_STELLAR_UVB_TRANSFER])
def test_padding_blocks_zero_and_parents_restricted(steps, mode):
    r = steps[mode]
    tsm, species0 = r["tsm"], r["species"]
    state, species = r["t_out"][:2]
    for spc, pad in zip(species0[1:], tsm.pad_masks(state)):
        assert pad.sum() == 1 and pad[-1]
        for k in SPECIES:
            assert not getattr(spc, k)[pad].any(), k
    for lv, spc, pad in zip(state.levels, species[1:], tsm.pad_masks(state)):
        for k in SPECIES:
            x = getattr(spc, k)
            assert bool(torch.isfinite(x).all()) and not x[pad].any(), k
        for k in ("HI", "HeI", "HeII", "Jmean", "krate24", "tgas"):
            x = getattr(lv.fields, k)
            assert not x[..., pad, :, :, :].any(), k
    # the state follows the species; refined parents hold the average of
    # their children's species (restricted through the blocks)
    assert torch.equal(state.base.HI, species[0].HI)
    for lv, spc in zip(state.levels, species[1:]):
        assert torch.equal(lv.fields.HI, spc.HI)
    back = tas.dense_from_sparse(dataclasses.replace(
        state, base=dataclasses.replace(state.base, HI=species[0].H2I),
        levels=tuple(dataclasses.replace(lv, fields=dataclasses.replace(
            lv.fields, HI=spc.H2I)) for lv, spc in zip(state.levels,
                                                       species[1:]))))
    for ell, r in enumerate(back.refined):
        coarse, fine = back.levels[ell].HI, back.levels[ell + 1].HI
        torch.testing.assert_close(coarse[r], tamr.restrict(fine)[r],
                                   rtol=1e-14, atol=0.0)


@pytest.mark.parametrize("mode", [MODE_UVB_TRANSFER_ONLY,
                                  MODE_BOTH_STELLAR_UVB_TRANSFER])
def test_noneq_sparse_matches_port_dense(steps, mode):
    """The port's dense MultiLevelModel noneq step from the same state:
    the same values on every level's covered cells."""
    r = steps[mode]
    trt, tc, tsm, tml, t_out = (r[k] for k in ("trt", "tc", "tsm", "tml",
                                               "t_out"))
    dense = tstep_amr.MultiLevelModel.setup(trt, L)
    sp_d = tuple(tcn.species_from_field_state(lv) for lv in tml.levels)
    d_out = dense.make_noneq_step(2.0 * MYR, tc, **KW)(tml, sp_d)
    back = tas.dense_from_sparse(t_out[0])
    cover = tamr.cover_masks(tml.refined, (N,) * 3, "cpu")
    for ell, (a, b, c) in enumerate(zip(back.levels, d_out[0].levels,
                                        cover)):
        for k in FIELDS:
            x, y = getattr(a, k), getattr(b, k)
            m = c.expand_as(x)
            assert float((x[m] - y[m]).abs().max()) <= 1e-9 * float(
                y[m].abs().max()), (ell, k)
        for k in SPECIES:
            x = getattr(t_out[1][ell], k)
            if ell:
                x = torch.as_tensor(tas.unblockify_like(
                    t_out[0].levels[ell - 1], x))
            y = getattr(d_out[1][ell], k)
            assert float((x[c] - y[c]).abs().max()) <= 1e-9 * float(
                y[c].abs().max()), (ell, k)
    assert tsm.neutral_fraction(t_out[0]) == pytest.approx(
        dense.neutral_fraction(d_out[0]), rel=1e-9)


@pytest.mark.parametrize("writer", ["torch", "jax"])
def test_species_sparse_snapshot_across_packages(steps, tmp_path, writer):
    """A block-sparse snapshot with each level's species written by one
    package: the other's read_species returns them bit for bit, level 0
    dense and the refined levels block-shaped."""
    r = steps[MODE_UVB_TRANSFER_ONLY]
    tsp, jsp = r["tsp"], r["jsp"]
    state, species = r["t_out"]
    j_species = tuple(jcn.SpeciesState(**{
        f.name: jnp.asarray(getattr(spc, f.name).numpy())
        for f in dataclasses.fields(spc)}) for spc in species)
    path = str(tmp_path / "cellArray0003.npz")
    if writer == "torch":
        extra = {}
        for ell, spc in enumerate(species):
            extra.update(tsnap.species_extra(spc, prefix=f"species{ell}"))
        tsnap.write_snapshot_sparse(path, state, 3, BOX, extra=extra)
        got = jsnap.read_species(path, j_species)
    else:
        extra = {}
        for ell, spc in enumerate(j_species):
            extra.update(jsnap.species_extra(spc, prefix=f"species{ell}"))
        jsnap.write_snapshot_sparse(path, jsp, 3, BOX, extra=extra)
        got = tsnap.read_species(path, species)
    assert isinstance(got, tuple) and len(got) == L
    for ell in range(L):
        for k in SPECIES:
            a = np.asarray(getattr(got[ell], k))
            b = getattr(species[ell], k).numpy()
            assert a.shape == b.shape == ((N,) * 3 if ell == 0 else
                                          tuple(tsp.levels[ell - 1]
                                                .cover.shape))
            np.testing.assert_array_equal(a, b, err_msg=f"{ell} {k}")
