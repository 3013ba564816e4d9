"""Chemistry-aware plotfile tools: plotXtoY, plotYtoX, plotTransportCoeff,
plotTYtoLe, plotQPD (PeleAnalysis Src/ModelSpecificAnalysis/).

Counterpart of ``peleanalysis_tpu/tools/chem_tools.py``.  Species are
discovered from the plotfile's X(name)/Y(name) variables (plotXtoY.cpp:72-99
convention) rather than compiled in; thermo, transport and kinetics come
from ``chem``.  The JAX tools evaluate in host numpy; here every level is
loaded in float64 onto the device and the conversions, transport and the
kinetics chain run there.  The levels go part by part (``level_parts``:
a whole level, or a sparse level's clusters of boxes), and outputs are
packed into the plotfile part by part (``PlotfileRecords``), so no tensor
spans a sparse level's union bbox.  plotQPD's kinetics path sums each
reaction's rates over the valid cells of each part on the card, in cell
chunks (``Kinetics.qf_qr_sums``), and fetches the sums once.
"""
from __future__ import annotations

import numpy as np
import torch

from .. import config
from ..amr.cluster import level_parts
from ..amr.dense import DenseAmrState, PlotfileRecords
from ..amr.hierarchy import load_plotfile_fabs
from ..chem.kinetics import Kinetics, parse_chemkin
from ..chem.mechanism import Mechanism, SimpleTransport, parse_chemkin_thermo
from ..chem.qpd import Reaction, edge_fluxes, get_edges
from ..io.plotfile import PlotfileReader
from ..parmparse import ParmParse
from .grad import refuse_unported
from .integral import integrate_along

TEMP_NAME = "Temp"


def _device(pp: ParmParse) -> torch.device:
    device = config.get_device(pp.query_str("device", "cuda"))
    refuse_unported(pp)
    return device


def _convert(args: dict, src_prefix: str, dst_prefix: str) -> None:
    pp = ParmParse(args)
    infile = pp.get_str("infile")
    device = _device(pp)
    var_names = PlotfileReader(infile).var_names
    mech = Mechanism.from_plotfile_vars(var_names, src_prefix)
    in_names = [f"{src_prefix}({s})" for s in mech.species]
    tname = TEMP_NAME if TEMP_NAME in var_names else (
        "temp" if "temp" in var_names else None)
    load = in_names + ([tname] if tname else [])
    meta, names, fabs = load_plotfile_fabs(
        infile, load, max_level=pp.query_int("finestLevel", None))
    ns = len(mech.species)
    out_names = [f"{dst_prefix}({s})" for s in mech.species] \
        + ([tname] if tname else [])
    out = PlotfileRecords(meta, out_names)
    for lev, idx, part in level_parts(meta, names, fabs, device,
                                      torch.float64):
        arr = part.data[lev]                        # [ncomp, *bbox]
        conv = mech.x_to_y(arr[:ns]) if src_prefix == "X" \
            else mech.y_to_x(arr[:ns])
        if tname:
            conv = torch.cat([conv, arr[ns:]])
        out.add(lev, conv, part.lmeta[lev].bbox, idx)
        del part, arr, conv
    out.write(pp.query_str("outfile", infile + f"_{dst_prefix}"))
    print("wrote output")


def _transport(args: dict, lewis_out: bool) -> None:
    pp = ParmParse(args)
    infile = pp.get_str("infile")
    device = _device(pp)
    var_names = PlotfileReader(infile).var_names
    prefix = "Y" if any(n.startswith("Y(") for n in var_names) else "X"
    mech = Mechanism.from_plotfile_vars(var_names, prefix)
    if pp.contains("thermo_file"):
        mech.thermo = parse_chemkin_thermo(pp.get_str("thermo_file"))
    tname = TEMP_NAME if TEMP_NAME in var_names else "temp"
    rname = pp.query_str("densityName",
                         "density" if "density" in var_names else None)
    load = [f"{prefix}({s})" for s in mech.species] + [tname] \
        + ([rname] if rname else [])
    meta, names, fabs = load_plotfile_fabs(
        infile, load, max_level=pp.query_int("finestLevel", None))
    tr = SimpleTransport(
        mu_ref=pp.query_float("mu_ref", 1.716e-4),
        prandtl=pp.query_float("prandtl", 0.7),
        lewis=pp.query_float("lewis", 1.0))
    ns = len(mech.species)
    if lewis_out:
        out_names = [f"Le({s})" for s in mech.species]
    else:
        out_names = ["viscosity", "conductivity", "diffusivity"]
    out = PlotfileRecords(meta, out_names)
    for lev, idx, part in level_parts(meta, names, fabs, device,
                                      torch.float64):
        arr = part.data[lev]
        Y = arr[:ns]
        if prefix == "X":
            Y = mech.x_to_y(Y)
        T = arr[ns]
        rho = arr[ns + 1] if rname else torch.ones_like(T)
        if mech.thermo:
            cp = mech.cp_mass(T, Y)
        else:
            cp = torch.full_like(T, 1.005e7)  # air-like cp [erg/(g K)]
        mu = tr.viscosity(T)
        lam = tr.conductivity(T, cp)
        D = tr.diffusivity(T, rho, cp, None)
        if lewis_out:
            le = lam / torch.clamp_min(rho * cp * D, 1e-300)
            comps = le.expand(ns, *le.shape)
        else:
            comps = torch.stack([mu, lam, D])
        out.add(lev, comps, part.lmeta[lev].bbox, idx)
        del part, arr, Y, comps
    out.write(pp.query_str("outfile",
                           infile + ("_Le" if lewis_out else "_transport")))
    print("wrote output")


def _qpd_rates_from_state(pp: ParmParse, infile: str, kin,
                          device) -> tuple:
    """Volume-integrated Qf/Qr per reaction from the plotfile's own
    T/density/X fields -- the reference's CKPX+CKKFKR per-cell chain over
    the valid (uncovered) cells with refinement-volume weighting
    (plotQPD.cpp:113-186), summed on the device; float64 numpy [nr]
    each."""
    ns = len(kin.species)
    avail = PlotfileReader(infile).var_names
    xnames = [f"X({s})" for s in kin.species]
    missing = [n for n in xnames if n not in avail]
    if missing:
        raise ValueError(f"plotQPD: plotfile lacks mole-fraction comps "
                         f"{missing}")
    tname = pp.query_str("TName", "temp" if "temp" in avail else "Temp")
    rname = pp.query_str("RName", "density")
    for n in (tname, rname):
        if n not in avail:
            raise ValueError(f"plotQPD: plotfile lacks '{n}'")
    meta, names, fabs = load_plotfile_fabs(
        infile, xnames + [tname, rname],
        max_level=pp.query_int("finestLevel", None))
    # density MKS->CGS like the reference (plotQPD.cpp:144: R*1e-3);
    # densityUnits=cgs skips the conversion for CGS plotfiles
    rho_scale = 1.0 if pp.query_str("densityUnits", "mks") == "cgs" else 1e-3
    kin.to(device)
    sums = torch.zeros(2, kin.n_reactions, dtype=torch.float64,
                       device=device)
    for lev, idx, part in level_parts(meta, names, fabs, device,
                                      torch.float64):
        arr = part.data[lev]                         # [ns+2, *bbox]
        mask = part.valid_mask(lev)                  # in-box, not covered
        cells = arr.permute(1, 2, 3, 0)[mask]        # [Ncells, ns+2]
        del part, arr
        if cells.shape[0] == 0:
            continue
        vol = float(np.prod(meta.geoms[lev].dx))
        qf, qr = kin.qf_qr_sums(cells[:, ns], cells[:, ns + 1] * rho_scale,
                                cells[:, :ns], weights=vol)
        sums[0] += qf
        sums[1] += qr
        del cells
    host = sums.cpu().numpy()
    return host[0], host[1]


def _qpd(args: dict) -> None:
    pp = ParmParse(args)
    mech_file = pp.get_str("mech_file")   # CHEMKIN mech (or bare reactions)
    device = _device(pp)
    # QPDatom is the reference's key (plotQPD.cpp:190); trace_element kept
    elt = pp.query_str("QPDatom", pp.query_str("trace_element", "C"))
    species, krxns, thermo = parse_chemkin(mech_file)
    if pp.contains("thermo_file"):
        thermo.update(parse_chemkin_thermo(pp.get_str("thermo_file")))
    reactions = [Reaction(r.reactants, r.products, r.reversible, r.label)
                 for r in krxns]
    edges = get_edges(reactions, elt)
    print(f"{len(reactions)} reactions, {len(edges)} {elt}-transfer edges")
    if pp.query_bool("dump_edges", False):     # plotQPD.cpp:204-209
        for e in edges:
            print(e)

    have_kinetics = bool(krxns) and all(r.has_arrhenius for r in krxns)
    Qfsum = np.ones(len(reactions))
    Qrsum = np.zeros(len(reactions))
    if pp.contains("infile"):
        infile = pp.get_str("infile")
        avail = PlotfileReader(infile).var_names
        rate_base = pp.query_str("rateBase", None)
        rate_names = [f"{rate_base}_{i}" for i in range(len(reactions))] \
            if rate_base else []
        if rate_base:
            # explicit override: net rates pre-baked as plotfile comps
            # rate_0..N-1; an explicit rateBase= with missing comps is an
            # error, never a quiet fall through to the kinetics path
            missing = [n for n in rate_names if n not in avail]
            if missing:
                raise ValueError(
                    f"plotQPD: rateBase={rate_base!r} was given but the "
                    f"plotfile lacks {missing[:3]}"
                    f"{'...' if len(missing) > 3 else ''} "
                    f"({len(missing)}/{len(rate_names)} missing)")
            ds = DenseAmrState.from_plotfile(infile, device,
                                             names=rate_names,
                                             dtype=torch.float64)
            _, _, fields = integrate_along(ds, rate_names, [0, 1, 2])
            Qfsum = np.array([float(v) for v in fields])
            Qrsum = np.zeros(len(reactions))
        elif have_kinetics:
            kin = Kinetics(species, krxns, thermo)
            Qfsum, Qrsum = _qpd_rates_from_state(pp, infile, kin, device)
        else:
            bad = [r.label for r in krxns if not r.has_arrhenius][:3]
            raise ValueError(
                "plotQPD: mechanism has reactions without Arrhenius data "
                f"(e.g. {bad}) and the plotfile carries no rateBase= "
                "components -- cannot evaluate rates")
    # per-edge forward/reverse fluxes (plotQPD.cpp:212-230)
    Qf_e = edge_fluxes(edges, Qfsum)
    Qr_e = edge_fluxes(edges, Qrsum)
    # normalization: normVal = 1/(net CH4->CH3 flux) * scaleNorm --
    # "normalize to CH4 destruction on the CH4->CH3 edge"
    # (plotQPD.cpp:214-244); without that edge normVal stays 1
    norm = 1.0
    for (s1, s2) in Qf_e:
        if {s1, s2} == {"CH4", "CH3"}:
            net = Qf_e[(s1, s2)] - Qr_e[(s1, s2)]
            if net != 0:
                norm = 1.0 / net
                if s2 == "CH4":
                    norm = -norm
    if pp.contains("scaleNorm"):
        norm *= pp.get_float("scaleNorm")
    print(f"NormVal: {norm}")
    if norm != 0:
        Qf_e = {k: w * norm for k, w in Qf_e.items()}
        Qr_e = {k: w * norm for k, w in Qr_e.items()}
    net = {k: Qf_e[k] - Qr_e[k] for k in Qf_e}
    if pp.contains("fuelSpec"):
        fuel = pp.get_str("fuelSpec")
        for (s1, s2), w in sorted(net.items(), key=lambda kv: -abs(kv[1])):
            if fuel in (s1, s2):
                print(f"{s1} -> {s2}: {w:e}")
    out = pp.query_str(
        "QPDfileName", pp.query_str("outfile", "QPD_edges.dat"))
    # reference format (plotQPD.cpp:196-246): label line, species line,
    # then 'left right Qf -Qr' per edge
    with open(out, "w") as f:
        f.write(pp.query_str("QPDlabel",
                             pp.query_str("infile", mech_file)) + "\n")
        f.write(" ".join(species) + " \n")
        for (s1, s2), w in sorted(net.items(), key=lambda kv: -abs(kv[1])):
            f.write(f"{s1} {s2} {Qf_e[(s1, s2)]:e} {-Qr_e[(s1, s2)]:e}\n")
    print(f"wrote {out}")


def main(args: dict) -> None:
    """CLI: plotXtoY | plotYtoX infile= [outfile=<infile>_Y|_X]
    [finestLevel=]; plotTransportCoeff | plotTYtoLe infile= [thermo_file=]
    [densityName=] [mu_ref=] [prandtl=] [lewis=] [outfile=]; plotQPD
    mech_file= [infile=] [QPDatom=C] [thermo_file=] [rateBase=] [TName=]
    [RName=] [densityUnits=mks|cgs] [scaleNorm=] [fuelSpec=] [dump_edges=]
    [QPDfileName=QPD_edges.dat] [QPDlabel=]; each [device=cuda|cpu].
    Plotfiles load float64."""
    tool = args.get("_tool", ["?"])[0]
    if tool == "plotXtoY":
        _convert(args, "X", "Y")
    elif tool == "plotYtoX":
        _convert(args, "Y", "X")
    elif tool == "plotTransportCoeff":
        _transport(args, lewis_out=False)
    elif tool == "plotTYtoLe":
        _transport(args, lewis_out=True)
    elif tool == "plotQPD":
        _qpd(args)
    else:
        raise ValueError(f"unknown chem tool {tool}")
