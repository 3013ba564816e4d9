"""The port never imports JAX or the JAX package, directly or through
another module: a child interpreter that refuses those imports still
imports every module of the port and runs its CLI."""
import os
import pkgutil
import subprocess
import sys

import peleanalysis_tpu_torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

BLOCKER = r'''
import importlib, importlib.abc, sys

class Refuse(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        # the exact name or a dotted child; a bare prefix match would also
        # refuse peleanalysis_tpu_torch
        for banned in ("jax", "jaxlib", "peleanalysis_tpu"):
            if name == banned or name.startswith(banned + "."):
                raise ImportError(f"refused import of {name}")
        return None

for mod in list(sys.modules):
    if mod.split(".")[0] in ("jax", "jaxlib", "peleanalysis_tpu"):
        del sys.modules[mod]
sys.meta_path.insert(0, Refuse())
'''


def _port_modules():
    pkg = peleanalysis_tpu_torch
    names = [pkg.__name__]
    for info in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + "."):
        if not info.name.endswith("__main__"):
            names.append(info.name)
    return names


def _run(code, *argv):
    env = dict(os.environ, PYTHONPATH=REPO)
    return subprocess.run([sys.executable, "-c", BLOCKER + code, *argv],
                          cwd=REPO, env=env, capture_output=True, text=True,
                          timeout=120)


def test_blocker_refuses_jax_but_not_the_port():
    res = _run("import importlib\n"
               "for m in ('jax', 'peleanalysis_tpu', "
               "'peleanalysis_tpu.cli'):\n"
               "    try:\n"
               "        importlib.import_module(m)\n"
               "    except ImportError:\n"
               "        continue\n"
               "    raise SystemExit(f'{m} imported')\n"
               "import peleanalysis_tpu_torch\n")
    assert res.returncode == 0, res.stderr


def test_every_port_module_imports_without_jax():
    mods = _port_modules()
    assert "peleanalysis_tpu_torch.ops.grad_kernels" in mods
    assert "peleanalysis_tpu_torch.tools.curvature" in mods
    for m in ("ops.cuda_build", "io.mef", "io.stream_data",
              "stream.march_kernels", "stream.trace", "stream.surface",
              "tools.stream", "tools.sample_streamlines", "geom.mc_tables",
              "geom.marching_cubes", "geom.marching_squares", "io.xdmf",
              "tools.isosurface", "ops.restrict", "ops.solve", "ops.stats",
              "ops.stats_kernels", "tools.conditional_mean", "tools.jpdf",
              "native", "io.fab_pack", "amr.cluster", "io.particles",
              "tools.part_stream", "tools.integral", "tools.rms_vel",
              "ops.filter", "tools.filter_plt", "tools.flatten_amr",
              "tools.turbulence_spectra", "tools.turbulence_post",
              "tools.sub_plt", "tools.combine_plts", "tools.regrid_plt",
              "tools.template", "tools.plt2npz", "tools.compare_plts",
              "tools.slice_plot", "tools.avg_to_plane",
              "tools.avg_plotfiles", "tools.amr_to_fe", "tools.interp",
              "tools.doctor", "geom.sdf", "tools.build_distance",
              "ops.vec3", "io.vtk", "geom.mef_tools", "tools.mef_tools",
              "tools.stream2plt", "tools.stream_scatter",
              "tools.stream_sub", "tools.stream_tube_stats", "chem",
              "chem.mechanism", "chem.kinetics", "chem.qpd",
              "tools.chem_tools", "tools.sco2", "tools.build_pmf",
              "session", "server", "io.prefetch", "parallel",
              "parallel.mesh", "parallel.dense_shard", "parallel.halo",
              "parallel.cluster_shard", "parallel.particles"):
        assert "peleanalysis_tpu_torch." + m in mods
    res = _run("import importlib, sys\n"
               "for m in sys.argv[1:]:\n"
               "    importlib.import_module(m)\n"
               "bad = [m for m in sys.modules if m.split('.')[0] in "
               "('jax', 'jaxlib', 'peleanalysis_tpu')]\n"
               "assert not bad, bad\n", *mods)
    assert res.returncode == 0, res.stderr


def test_cli_help_runs_without_jax():
    res = _run("import runpy, sys\n"
               "sys.argv = ['peleanalysis_tpu_torch', '--help']\n"
               "runpy.run_module('peleanalysis_tpu_torch', "
               "run_name='__main__')\n")
    assert res.returncode == 0, res.stderr
    assert "grad" in res.stdout and "curvature" in res.stdout
    assert "stream" in res.stdout and "sampleStreamlines" in res.stdout
    assert "isosurface" in res.stdout
    assert "conditionalMean" in res.stdout and "jpdf" in res.stdout
    tools = res.stdout.split("tools:")[-1].split()
    # the 56 tool verbs and the three driver verbs
    assert len(tools) == 59 and tools[-3:] == ["pipeline", "serve", "send"]
    for t in ("partStream", "integral", "rmsVel", "filterPlt",
              "flattenAMRFile", "turbulenceSpectra", "turbulenceTseries",
              "turbulenceSlice", "augmentPlotfile", "varfieldAverage",
              "avgPlotfiles", "combinePlts", "subPlt", "regridPlt",
              "avgToPlane", "slicePlot", "amrToFE", "interp", "plt2npz",
              "npz2plt", "fcompare", "fextrema", "template", "doctor",
              "buildDistance", "isoMEF", "combineMEF", "mergeMEF",
              "multMEF", "scaleMEF", "sliceMEF", "smoothMEF", "trimMEFgen",
              "binMEF", "decimateMEF", "surfDATtoMEF", "surfMEFtoDAT",
              "checkIso", "stream2plt", "streamScatter", "streamSub",
              "streamTubeStats", "plotXtoY", "plotYtoX",
              "plotTransportCoeff", "plotTYtoLe", "plotQPD", "sCO2",
              "buildPMF"):
        assert t in tools


def test_pipeline_runs_without_jax(tmp_path):
    """A pipeline (grad, then an isosurface kept in memory with write=0,
    then stream seeded from it) through the port's CLI in a child
    interpreter that refuses JAX; its files read back."""
    res = _run("import os, sys\n"
               "from peleanalysis_tpu_torch import cli\n"
               "from peleanalysis_tpu_torch.io.plotfile import "
               "PlotfileReader\n"
               "from peleanalysis_tpu_torch.testing import "
               "write_synthetic_plotfile\n"
               "os.chdir(sys.argv[1])\n"
               "write_synthetic_plotfile('plt', n_cell=16, n_levels=2, "
               "max_grid_size=8)\n"
               "d = 'device=cpu'\n"
               "assert cli.main(['pipeline', 'grad', 'infile=plt', "
               "'outfile=g', d, '--', 'isosurface', 'infile=plt', "
               "'outfile_base=s', 'write=0', d, '--', 'stream', "
               "'plotfile=plt', 'isoFile=s.mef', 'nRKsteps=5', "
               "'outFile=l.dat', d]) == 0\n"
               "assert not os.path.exists('s.mef')\n"
               "assert PlotfileReader('g').var_names[-1] == '||gradtemp||'\n"
               "assert open('l.dat').readline().startswith('VARIABLES')\n"
               "assert cli.main(['--help']) == 0\n",
               str(tmp_path))
    assert res.returncode == 0, res.stderr
    assert "wrote g" in res.stdout and "wrote l.dat" in res.stdout
    assert "pipeline serve send" in res.stdout


def test_isosurface_cli_runs_without_jax(tmp_path):
    """A tiny extraction through the port's CLI, its MEF read back."""
    res = _run("import sys\n"
               "from peleanalysis_tpu_torch import cli\n"
               "from peleanalysis_tpu_torch.io.mef import read_mef\n"
               "from peleanalysis_tpu_torch.testing import "
               "write_synthetic_plotfile\n"
               "plt, base = sys.argv[1] + '/plt', sys.argv[1] + '/surf'\n"
               "write_synthetic_plotfile(plt, n_cell=16, n_levels=2, "
               "max_grid_size=8)\n"
               "assert cli.main(['isosurface', 'infile=' + plt, "
               "'outfile_base=' + base, 'device=cpu']) == 0\n"
               "assert read_mef(base + '.mef').n_elts > 100\n",
               str(tmp_path))
    assert res.returncode == 0, res.stderr
    assert "wrote" in res.stdout


def test_stats_clis_run_without_jax(tmp_path):
    """conditionalMean and jpdf through the port's CLI, outputs read back."""
    res = _run("import os, sys\n"
               "import numpy as np\n"
               "from peleanalysis_tpu_torch import cli\n"
               "from peleanalysis_tpu_torch.testing import "
               "write_synthetic_plotfile\n"
               "os.chdir(sys.argv[1])\n"
               "write_synthetic_plotfile('plt', n_cell=16, n_levels=2, "
               "max_grid_size=8)\n"
               "assert cli.main(['conditionalMean', 'infile=plt', "
               "'binComp=temp', 'avgComps=density', 'nBins=8', "
               "'binMin=300', 'binMax=1801', 'outfile=cm.dat', "
               "'device=cpu']) == 0\n"
               "assert np.loadtxt('cm.dat', skiprows=2).shape == (8, 7)\n"
               "assert cli.main(['jpdf', 'infile=plt', 'vars=temp density', "
               "'nBins=8', 'output_gnuplot=1', 'device=cpu']) == 0\n"
               "g = np.loadtxt('plt/Pdf_temp_density.gpd')\n"
               "assert abs(g[:, 2].sum() - 1) < 1e-5\n",
               str(tmp_path))
    assert res.returncode == 0, res.stderr
    assert "wrote cm.dat" in res.stdout and "jpdf done" in res.stdout


def test_hit_clis_run_without_jax(tmp_path):
    """partStream and the turbulence tools through the port's CLI on a
    small HIT run, outputs read back."""
    res = _run("import os, sys\n"
               "import numpy as np\n"
               "from peleanalysis_tpu_torch import cli\n"
               "from peleanalysis_tpu_torch.io.particles import "
               "read_particles\n"
               "from peleanalysis_tpu_torch.testing import write_hit_run\n"
               "os.chdir(sys.argv[1])\n"
               "plts = write_hit_run('.', n_cell=16, max_grid_size=8)\n"
               "assert cli.main(['partStream', 'infile=' + plts[0], "
               "'seedLoc=0.3 0.4 0.5', 'Nsteps=11', 'partFile=parts', "
               "'device=cpu']) == 0\n"
               "pos, reals, _ = read_particles('parts')\n"
               "assert pos.shape == (1, 3) and len(reals) == 33\n"
               "for tool in ('turbulenceTseries', 'turbulenceSlice'):\n"
               "    assert cli.main([tool, 'root_dir=.', "
               "'plotfile=plt00001', 'device=cpu']) == 0\n"
               "assert cli.main(['turbulenceSpectra', 'infile=' + "
               "' '.join(plts), 'device=cpu']) == 0\n"
               "E = np.loadtxt('turb_plt00001_spectrum.dat')[:, 1]\n"
               "assert abs(E.sum() - 0.75) < 1e-9\n",
               str(tmp_path))
    assert res.returncode == 0, res.stderr
    assert "wrote ./tseries.csv" in res.stdout


def test_plt_tools_run_without_jax(tmp_path):
    """The plotfile tools and buildDistance through the port's CLI, their
    outputs read back."""
    res = _run("import os, sys\n"
               "import numpy as np\n"
               "from peleanalysis_tpu_torch import cli\n"
               "from peleanalysis_tpu_torch.io.plotfile import "
               "PlotfileReader\n"
               "from peleanalysis_tpu_torch.testing import "
               "write_synthetic_plotfile\n"
               "os.chdir(sys.argv[1])\n"
               "write_synthetic_plotfile('plt', n_cell=16, n_levels=2, "
               "max_grid_size=8)\n"
               "d = ['device=cpu']\n"
               "for args in (['subPlt', 'infile=plt', 'box=2 2 2 9 9 9'],\n"
               "             ['regridPlt', 'infile=plt'],\n"
               "             ['avgPlotfiles', 'infile=plt plt'],\n"
               "             ['plt2npz', 'infile=plt', 'mode=flat'],\n"
               "             ['npz2plt', 'infile=plt.npz', 'outfile=rt'],\n"
               "             ['isosurface', 'infile=plt', "
               "'isoCompName=progress', 'isoVal=0.5', 'outfile_base=s',\n"
               "              'build_distance_function=1'],\n"
               "             ['buildDistance', 'infile=plt', "
               "'isoFile=s.mef', 'signComp=progress', 'isoVal=0.5',\n"
               "              'outfile=bd'],\n"
               "             ['fcompare', 'infile1=plt_dist', "
               "'infile2=bd'],\n"
               "             ['doctor']):\n"
               "    assert cli.main(args + (d if args[0] != 'doctor' "
               "else [])) == 0\n"
               "assert PlotfileReader('plt_avg').meta.n_levels == 2\n"
               "assert PlotfileReader('rt').var_names[0] == 'temp'\n",
               str(tmp_path))
    assert res.returncode == 0, res.stderr
    assert "PLOTFILES AGREE" in res.stdout and "wrote plt_sub" in res.stdout


def test_mef_and_stream_post_clis_run_without_jax(tmp_path):
    """decimateMEF (the port's qem.cpp build), binMEF and checkIso on an
    isosurface, and stream2plt and streamTubeStats on a StreamData seeded
    from it, through the port's CLI; outputs read back."""
    res = _run("import os, sys\n"
               "from peleanalysis_tpu_torch import cli\n"
               "from peleanalysis_tpu_torch.io.mef import read_mef\n"
               "from peleanalysis_tpu_torch.testing import "
               "write_synthetic_plotfile\n"
               "os.chdir(sys.argv[1])\n"
               "write_synthetic_plotfile('plt', n_cell=16, n_levels=2, "
               "max_grid_size=8)\n"
               "d = ['device=cpu']\n"
               "for args in (['isosurface', 'infile=plt', "
               "'isoCompName=progress', 'isoVal=0.5', 'outfile_base=s'],\n"
               "             ['decimateMEF', 'infile=s.mef', "
               "'outfile=dec.mef'],\n"
               "             ['checkIso', 'infile=dec.mef'],\n"
               "             ['binMEF', 'infile=s.mef', 'binComps=Z', "
               "'binMin=0', 'binMax=1', 'nBins=4'],\n"
               "             ['stream', 'plotfile=plt', "
               "'progressName=progress', 'isoFile=s.mef', 'nRKsteps=5',\n"
               "              'hRK=0.5', 'streamFile=sd'],\n"
               "             ['stream2plt', 'infile=sd', 'outfile=l.fab'],\n"
               "             ['streamTubeStats', 'infile=sd', "
               "'outfile=tube', 'nSmooth=1']):\n"
               "    assert cli.main(args + d) == 0\n"
               "assert read_mef('dec.mef').n_elts < read_mef('s.mef').n_elts\n"
               "assert read_mef('tube.mef').n_elts == "
               "read_mef('s.mef').n_elts\n"
               "print(sorted({l.split()[-1] for l in open('/proc/self/maps') "
               "if l.rstrip().endswith('.so') and 'pele_native' in l}))\n",
               str(tmp_path))
    assert res.returncode == 0, res.stderr
    assert "decimated" in res.stdout and "watertight: True" in res.stdout
    assert "binMEF done" in res.stdout and "wrote tube.mef" in res.stdout
    build = os.path.join(REPO, "build", "peleanalysis_tpu_torch")
    assert build in res.stdout


def test_chem_clis_run_without_jax(tmp_path):
    """plotXtoY and buildPMF through the port's CLI, outputs read back."""
    res = _run("import os, sys\n"
               "import numpy as np\n"
               "from peleanalysis_tpu_torch import cli\n"
               "from peleanalysis_tpu_torch.io.plotfile import "
               "PlotfileReader\n"
               "from peleanalysis_tpu_torch.testing import "
               "fraction_fields, write_synthetic_plotfile\n"
               "os.chdir(sys.argv[1])\n"
               "f = fraction_fields(['CH4', 'O2', 'N2'])\n"
               "f['temp'] = lambda x, y, z: 300 + 1000 * x\n"
               "write_synthetic_plotfile('plt', n_cell=16, n_levels=2, "
               "max_grid_size=8, fields=f)\n"
               "assert cli.main(['plotXtoY', 'infile=plt', 'outfile=y', "
               "'device=cpu']) == 0\n"
               "r = PlotfileReader('y')\n"
               "assert r.var_names == ['Y(CH4)', 'Y(O2)', 'Y(N2)', 'temp']\n"
               "y = r.read_level(1)[0]\n"
               "assert np.allclose(y[:3].sum(axis=0), 1.0, rtol=1e-12)\n"
               "np.savetxt('flame.dat', np.column_stack("
               "[np.linspace(0, 1, 5), np.arange(5.0)]))\n"
               "assert cli.main(['buildPMF', 'infile=flame.dat', "
               "'fortran=pmf.f90', 'device=cpu']) == 0\n"
               "assert 'pmf_N = 5' in open('pmf.f90').read()\n",
               str(tmp_path))
    assert res.returncode == 0, res.stderr
    assert "wrote output" in res.stdout and "wrote pmf.dat" in res.stdout


def test_native_library_is_the_ports_own(tmp_path):
    """The loader and the formatter run from the port's own g++ build under
    build/peleanalysis_tpu_torch/; no library of the JAX package's
    directory is loaded (checked on the process's memory map)."""
    res = _run("import os, sys\n"
               "import numpy as np\n"
               "from peleanalysis_tpu_torch import native\n"
               "from peleanalysis_tpu_torch.io.plotfile import "
               "PlotfileReader\n"
               "from peleanalysis_tpu_torch.testing import "
               "write_synthetic_plotfile\n"
               "plt = sys.argv[1] + '/plt'\n"
               "write_synthetic_plotfile(plt, n_cell=16, n_levels=2, "
               "max_grid_size=8)\n"
               "assert len(PlotfileReader(plt).read_level(1)) > 1\n"
               "assert native.format_g_rows(np.ones((2, 2))) == "
               "b'1 1\\n1 1\\n'\n"
               "with open('/proc/self/maps') as f:\n"
               "    print('\\n'.join(sorted({l.split()[-1] for l in f "
               "if l.rstrip().endswith('.so')})))\n"
               "print('LIB', native.get_lib()._name)\n",
               str(tmp_path))
    assert res.returncode == 0, res.stderr
    lib = res.stdout.split("LIB ")[-1].strip()
    build = os.path.join(REPO, "build", "peleanalysis_tpu_torch") + os.sep
    assert lib.startswith(build) and os.path.basename(lib).startswith(
        "libpele_native_")
    mapped = res.stdout.split("LIB ")[0].split()
    assert os.path.realpath(lib) in {os.path.realpath(m) for m in mapped}
    jax_dir = os.path.join(REPO, "peleanalysis_tpu") + os.sep
    assert not [m for m in mapped if os.path.realpath(m).startswith(jax_dir)]
