"""Results output: cube files, molden natural orbitals, tables, plots.

Re-implements reference utilities.py:884-978 (printNO, cube, diff_cube) and
Main.py:956-1179 (print_results, print_results_ES, plot_results*) without
PySCF's cubegen/molden — densities are evaluated on the grid with the
in-house AO evaluator (models/integrals.eval_ao).

Copy of ecw_cc_tpu/utils/output.py (the PyTorch port imports
nothing of the JAX package); only the imports differ.
"""

from __future__ import annotations

import numpy as np

from ecw_cc_torch.models.integrals import eval_ao
from ecw_cc_torch.utils import convert

try:
    from tabulate import tabulate
except ImportError:  # pragma: no cover
    def tabulate(rows, headers=None, tablefmt=None):
        lines = ["\t".join(map(str, headers or []))]
        lines += ["\t".join(map(str, r)) for r in rows]
        return "\n".join(lines)

BOHR = 0.52917721092


# ---------------------------------------------------------------------------
# Cube files
# ---------------------------------------------------------------------------

def _cube_grid(mol, nx, ny, nz, margin=4.0):
    coords = mol.coords
    lo = coords.min(axis=0) - margin
    hi = coords.max(axis=0) + margin
    xs = np.linspace(lo[0], hi[0], nx)
    ys = np.linspace(lo[1], hi[1], ny)
    zs = np.linspace(lo[2], hi[2], nz)
    return lo, xs, ys, zs


def cube_density(mol, fname, rdm1_ao_r, nx=80, ny=80, nz=80):
    """Write the density of an AO R-format rdm1 as a Gaussian cube file
    (equivalent to pyscf.tools.cubegen.density, used in Main.py:206-213)."""
    if not fname.endswith(".cube"):
        fname = fname + ".cube"
    lo, xs, ys, zs = _cube_grid(mol, nx, ny, nz)
    dx = (xs[1] - xs[0]) if nx > 1 else 1.0
    dy = (ys[1] - ys[0]) if ny > 1 else 1.0
    dz = (zs[1] - zs[0]) if nz > 1 else 1.0
    with open(fname, "w") as f:
        f.write("Electron density in real space (e/Bohr^3)\n")
        f.write("ecw_cc_tpu cube file\n")
        f.write(f"{mol.natm:5d}{lo[0]:12.6f}{lo[1]:12.6f}{lo[2]:12.6f}\n")
        f.write(f"{nx:5d}{dx:12.6f}{0.0:12.6f}{0.0:12.6f}\n")
        f.write(f"{ny:5d}{0.0:12.6f}{dy:12.6f}{0.0:12.6f}\n")
        f.write(f"{nz:5d}{0.0:12.6f}{0.0:12.6f}{dz:12.6f}\n")
        for (sym, xyz), Z in zip(mol.atoms, mol.charges):
            f.write(f"{int(Z):5d}{Z:12.6f}{xyz[0]:12.6f}{xyz[1]:12.6f}{xyz[2]:12.6f}\n")
        # evaluate density plane by plane to bound memory
        for ix in range(nx):
            plane = np.array([[xs[ix], y, z] for y in ys for z in zs])
            ao = eval_ao(mol.bs, plane)  # (ny*nz, nao)
            rho = np.einsum("pi,ij,pj->p", ao, rdm1_ao_r, ao)
            vals = rho.reshape(ny, nz)
            for iy in range(ny):
                row = vals[iy]
                for k in range(0, nz, 6):
                    f.write("".join(f"{v:13.5e}" for v in row[k:k + 6]) + "\n")
    return fname


def cube_rdm1(rdm1_mo, mo_coeff, mol, fout, g=True, nx=80, ny=80, nz=80):
    """MO-basis rdm1 -> AO density cube. Reference utilities.py:917-937."""
    rdm1_ao = np.einsum("pi,ij,qj->pq", mo_coeff, np.asarray(rdm1_mo),
                        np.conj(mo_coeff))
    if g:
        rdm1_ao = convert.convert_g_to_ru_rdm1(rdm1_ao)[0]
    return cube_density(mol, str(fout), rdm1_ao, nx=nx, ny=ny, nz=nz)


def cube_orbital_g(vec_mo_g, mo_coeff_g, mol, fout, nx=80, ny=80, nz=80):
    """|phi(r)|^2 of a spin-orbital-basis vector (e.g. a Dyson orbital from
    ops/eom_ipea.dyson_orbitals) as a cube file: the alpha and beta spatial
    components enter as a rank-2 R-format AO density."""
    c = np.asarray(mo_coeff_g) @ np.asarray(vec_mo_g)
    nao = c.shape[0] // 2
    dm = np.outer(c[:nao], c[:nao]) + np.outer(c[nao:], c[nao:])
    return cube_density(mol, str(fout), dm, nx=nx, ny=ny, nz=nz)


def diff_cube(file1, file2, out):
    """Difference of two cube files. Reference utilities.py:940-978."""
    initial_line = 6
    with open(file1) as f1, open(file2) as f2:
        l1 = f1.readlines()
        l2 = f2.readlines()
    natm = int(l1[2].split()[0])
    head_end = initial_line + natm
    out_lines = l1[: head_end]
    for a, b in zip(l1[head_end:], l2[head_end:]):
        va = [float(x) for x in a.split()]
        vb = [float(x) for x in b.split()]
        out_lines.append("".join(f"{x - y:13.5e}" for x, y in zip(va, vb)) + "\n")
    if not out.endswith(".cube"):
        out = out + ".cube"
    with open(out, "w") as f:
        f.writelines(out_lines)
    return out


def printNO(rdm1, mf, mol, fout):
    """Natural orbitals in molden format. Reference utilities.py:884-914."""
    import scipy.linalg

    no_occ, no = scipy.linalg.eigh(np.asarray(rdm1))
    no_occ = no_occ[::-1]
    no = no[:, ::-1]
    no_coeff = mf.mo_coeff @ no
    out = fout + ".molden"
    with open(out, "w") as f:
        f.write("[Molden Format]\n[Title]\nNatural orbitals (ecw_cc_tpu)\n")
        f.write("[Atoms] AU\n")
        for i, ((sym, xyz), Z) in enumerate(zip(mol.atoms, mol.charges)):
            f.write(f"{sym} {i + 1} {int(Z)} {xyz[0]:.8f} {xyz[1]:.8f} {xyz[2]:.8f}\n")
        f.write("[GTO]\n")
        from ecw_cc_torch.models.basis_data import get_basis
        for i, (sym, _) in enumerate(mol.atoms):
            f.write(f"{i + 1} 0\n")
            for (l, prims) in get_basis(mol.basis_name, sym):
                lchar = "spdf"[l]
                f.write(f" {lchar} {len(prims)} 1.00\n")
                for e, c in prims:
                    f.write(f"  {e:.8e} {c:.8e}\n")
            f.write("\n")
        f.write("[5D]\n[MO]\n")
        nao = mol.nao
        for k in range(no_coeff.shape[1]):
            f.write(" Sym= A\n")
            ene = mf.mo_energy[k] if k < len(mf.mo_energy) else 0.0
            f.write(f" Ene= {ene:.6f}\n Spin= Alpha\n")
            f.write(f" Occup= {no_occ[k]:.6f}\n")
            col = no_coeff[:, k]
            # G-format: fold AO blocks (print alpha block)
            vec = col[:nao] if len(col) == 2 * nao else col
            for a in range(len(vec)):
                f.write(f" {a + 1} {vec[a]:.10e}\n")
    return out


# ---------------------------------------------------------------------------
# Tables and plots (reference Main.py:956-1179)
# ---------------------------------------------------------------------------

def print_iteration_table(Result, conv, tablefmt="rst"):
    print("Iteration steps")
    headers = ["ite", "Ep", str(conv), "Delta"]
    rows = []
    for i in range(len(Result[1])):
        rows.append([i, f"{Result[1][i]:.4e}", f"{Result[3][i]:.4e}",
                     f"{Result[2][i][0]:.4e}"])
    print(tabulate(rows, headers, tablefmt=tablefmt))


def print_results_gs(ecw, out_dir=None):
    import os

    if out_dir is not None:
        os.makedirs(out_dir, exist_ok=True)
        ecw.out_dir = out_dir
    if len(ecw.Delta_lamb) and isinstance(ecw.Delta_lamb[0], (list, np.ndarray)) \
            and not np.isscalar(ecw.Delta_lamb[0]):
        print("Warning: excited state results detected, calling ES print")
        return print_results_es(ecw)
    out_target = []
    for st in ecw.exp_data:
        for prop in st:
            out_target.append(["mat"] if "mat" in prop[0] else [prop])
    info = (f"molecule: {ecw.molecule} \n method: {ecw.method} \n "
            f"basis: {ecw.mol.basis_name} \n target data: {out_target} \n")
    data = np.column_stack([ecw.Larray, ecw.Delta_lamb, ecw.Ep_lamb, ecw.vmax_lamb])
    header = ["L", "Delta", "Ep", "vmax"]
    if ecw.Delta_Ek:
        data = np.column_stack([data, ecw.Delta_Ek])
        header.append("Delta_Ek")
    if ecw.Delta_rdm1 is not None and len(np.atleast_1d(ecw.Delta_rdm1)):
        data = np.column_stack([data, ecw.Delta_rdm1])
        header.append("Delta_rdm1_GS")
    if ecw.out_dir is not None:
        with open(os.path.join(ecw.out_dir, "output.txt"), "w") as f:
            f.write(info)
            f.write(tabulate(data, headers=header))
    else:
        print(info)
        print(tabulate(data, headers=header))


def print_results_es(ecw, out_dir=None):
    import os

    if out_dir is not None:
        os.makedirs(out_dir, exist_ok=True)
        ecw.out_dir = out_dir
    info = (f"molecule: {ecw.molecule} \n method: {ecw.method} \n "
            f"basis: {ecw.mol.basis_name} \n target data: {ecw.exp_data} \n")
    header = ["L", "Ep_GS"]
    for n in range(1, ecw.nbr_ES + 1):
        header.extend([f"Deltar_{n}", f"Deltal_{n}", f"Er_{n}", f"El_{n}"])
    data = np.zeros((len(ecw.Ep_lamb), 2 + 4 * ecw.nbr_ES))
    data[:, 0] = ecw.Larray
    for i in range(len(ecw.Larray)):
        data[i, 2::4] = ecw.Delta_lamb[i][0]
        data[i, 3::4] = ecw.Delta_lamb[i][1]
        data[i, 1] = ecw.Ep_lamb[i][0][0]
        data[i, 4::4] = ecw.Ep_lamb[i][0][1:]
        data[i, 5::4] = ecw.Ep_lamb[i][1][1:]
    if ecw.Delta_rdm1 is not None:
        header.append("Delta_rdm1_GS")
        data = np.hstack([data, np.asarray(ecw.Delta_rdm1).reshape(-1, 1)])
    if ecw.out_dir is not None:
        with open(os.path.join(ecw.out_dir, "output.txt"), "w") as f:
            f.write(info)
            f.write(tabulate(data, headers=header))
    else:
        print(info)
        print(tabulate(data, headers=header))


def plot_results_gs(ecw):
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, axs1 = plt.subplots(2, sharex="col")
    axs2 = [a.twinx() for a in axs1]
    axs1[0].plot(ecw.Larray, ecw.Ep_lamb, marker="o", markersize=4,
                 color="grey", linewidth=1)
    axs1[0].set_ylabel("E_HF - Ep (au)")
    axs1[1].plot(ecw.Larray, ecw.Delta_lamb, marker="o", markersize=5,
                 color="orange", linewidth=1)
    if ecw.Delta_rdm1 is not None and len(np.atleast_1d(ecw.Delta_rdm1)) \
            and ecw.cal_rdm1_Delta:
        axs2[1].plot(ecw.Larray, ecw.Delta_rdm1, marker="x", markersize=5,
                     color="red", linewidth=1)
        axs2[1].set_ylabel("Delta_target (-)")
    else:
        axs2[1].plot(ecw.Larray, ecw.vmax_lamb, marker="o", markersize=4,
                     color="lightblue", linewidth=1)
        axs2[1].set_ylabel("V_max")
    axs1[1].set_ylabel("Delta (-)")
    axs1[1].set_xlabel("lambda")
    if ecw.Delta_Ek:
        axs2[0].plot(ecw.Larray, ecw.Delta_Ek, marker="o", markersize=4,
                     color="black", linewidth=1)
        axs2[0].set_ylabel("Delta Ek (-)")
    return fig


def plot_results_es(ecw):
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, axs1 = plt.subplots(2, sharex="col")
    axs2 = [a.twinx() for a in axs1]
    color1 = ["red", "blue", "darkgreen"]
    color2 = ["orange", "lightblue", "green"]
    axs2[0].plot(ecw.Larray, [e[0][0] for e in ecw.Ep_lamb], marker="o",
                 markersize=4, color="grey", linewidth=1)
    for n in range(ecw.nbr_ES):
        axs1[0].plot(ecw.Larray, [e[0][n + 1] for e in ecw.Ep_lamb], marker="o",
                     markersize=4, color=color2[n % 3], linestyle="-.")
        axs1[0].plot(ecw.Larray, [e[1][n + 1] for e in ecw.Ep_lamb], marker="o",
                     markersize=4, color=color2[n % 3], linestyle="--")
        axs1[1].plot(ecw.Larray, [d[0][n] * 100 for d in ecw.Delta_lamb],
                     marker="o", markersize=5, color=color1[n % 3], linestyle="-.")
        axs1[1].plot(ecw.Larray, [d[1][n] * 100 for d in ecw.Delta_lamb],
                     marker="o", markersize=5, color=color1[n % 3], linestyle="--")
    if ecw.Delta_rdm1 is not None:
        axs2[1].plot(ecw.Larray, ecw.Delta_rdm1, marker="o", markersize=4,
                     color="grey", linewidth=1)
    axs1[1].set_xlabel("lambda")
    return fig
