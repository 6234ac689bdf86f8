// Native McMurchie-Davidson electron-repulsion-integral engine.
//
// Copy of ecw_cc_tpu/native/mdint.cpp for the PyTorch port (unchanged).
//
// The host-side native component of ecw_cc_tpu: computes the full spherical
// (nao^4) ERI tensor in chemists' notation (ij|kl) for contracted spherical
// Gaussians up to l = 4 (s,p,d,f,g).  Replaces the role PySCF's libcint plays
// for the reference implementation (reference Eris.py:97-131); the NumPy
// engine in models/integrals.py remains as the pure-Python fallback and
// cross-check oracle.
//
// Algorithm: per shell pair, Hermite expansion coefficients E_t^{ij} are
// precomputed per primitive pair and combined into per-pair Hermite
// representations H[prim][tuv][cart]; per shell quartet the Hermite Coulomb
// tensor R_{t+tau,u+nu,v+phi} is built by downward recursion from Boys
// F_n(T) and contracted bra x ket.  8-fold permutational symmetry.
//
// Build: g++ -O3 -shared -fPIC mdint.cpp -o libmdint.so

#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

constexpr int LMAX = 4;                 // up to g shells
constexpr int NCART[] = {1, 3, 6, 10, 15};
constexpr int NSPH[] = {1, 3, 5, 7, 9};
constexpr double PI = 3.14159265358979323846;

struct Cart { int x, y, z; };
static const Cart CARTS[5][15] = {
    {{0,0,0}},
    {{1,0,0},{0,1,0},{0,0,1}},
    {{2,0,0},{1,1,0},{1,0,1},{0,2,0},{0,1,1},{0,0,2}},
    {{3,0,0},{2,1,0},{2,0,1},{1,2,0},{1,1,1},{1,0,2},{0,3,0},{0,2,1},{0,1,2},{0,0,3}},
    {{4,0,0},{3,1,0},{3,0,1},{2,2,0},{2,1,1},{2,0,2},{1,3,0},{1,2,1},{1,1,2},{1,0,3},
     {0,4,0},{0,3,1},{0,2,2},{0,1,3},{0,0,4}},
};

// real-solid-harmonic coefficients over plain cartesian monomials, PySCF
// spherical ordering (matches models/integrals._c2s_matrix; l=3 rows are
// m = -3..3 with the same normalization convention: equal self-overlap per m)
static void c2s_matrix(int l, double* M /* NSPH x NCART row-major */) {
    std::memset(M, 0, sizeof(double) * NSPH[l] * NCART[l]);
    const double s3 = std::sqrt(3.0);
    switch (l) {
    case 0: M[0] = 1.0; break;
    case 1: M[0*3+0] = 1.0; M[1*3+1] = 1.0; M[2*3+2] = 1.0; break;
    case 2:
        // rows: xy, yz, z2, xz, x2-y2 ; cols: xx xy xz yy yz zz
        M[0*6+1] = s3;
        M[1*6+4] = s3;
        M[2*6+0] = -0.5; M[2*6+3] = -0.5; M[2*6+5] = 1.0;
        M[3*6+2] = s3;
        M[4*6+0] = s3/2; M[4*6+3] = -s3/2;
        break;
    case 3: {
        // cols: xxx xxy xxz xyy xyz xzz yyy yyz yzz zzz
        const double a = std::sqrt(5.0/8.0), b = std::sqrt(15.0),
                     c = std::sqrt(3.0/8.0);
        double* r;
        r = M + 0*10; r[1] = 3*a; r[6] = -a;                       // m=-3: sqrt(5/8)(3x^2y - y^3)
        r = M + 1*10; r[4] = b;                                    // m=-2: sqrt(15) xyz
        r = M + 2*10; r[8] = 4*c; r[1] = -c; r[6] = -c;            // m=-1: sqrt(3/8)(4yz^2 - x^2y - y^3)
        r = M + 3*10; r[9] = 1.0; r[2] = -1.5; r[7] = -1.5;        // m=0:  z^3 - 3/2 (x^2+y^2) z
        r = M + 4*10; r[5] = 4*c; r[0] = -c; r[3] = -c;            // m=+1: sqrt(3/8)(4xz^2 - x^3 - xy^2)
        r = M + 5*10; r[2] = b/2; r[7] = -b/2;                     // m=+2: sqrt(15)/2 (x^2-y^2) z
        r = M + 6*10; r[0] = a; r[3] = -3*a;                       // m=+3: sqrt(5/8)(x^3 - 3xy^2)
        break; }
    case 4: {
        // cols: x4 x3y x3z x2y2 x2yz x2z2 xy3 xy2z xyz2 xz3 y4 y3z y2z2 yz3 z4
        // identical constants to models/integrals._c2s_matrix(4)
        const double c = std::sqrt(35.0)/8.0, d = std::sqrt(35.0/8.0),
                     e = std::sqrt(5.0)/2.0, f = std::sqrt(5.0/8.0);
        double* r;
        r = M + 0*15; r[1] = 4*c; r[6] = -4*c;                     // m=-4: xy(x2-y2)
        r = M + 1*15; r[4] = 3*d; r[11] = -d;                      // m=-3: yz(3x2-y2)
        r = M + 2*15; r[1] = -e; r[6] = -e; r[8] = 6*e;            // m=-2: xy(7z2-r2)
        r = M + 3*15; r[4] = -3*f; r[11] = -3*f; r[13] = 4*f;      // m=-1
        r = M + 4*15; r[0] = 0.375; r[3] = 0.75; r[5] = -3.0;      // m=0
                      r[10] = 0.375; r[12] = -3.0; r[14] = 1.0;
        r = M + 5*15; r[2] = -3*f; r[7] = -3*f; r[9] = 4*f;        // m=+1
        r = M + 6*15; r[0] = -e/2; r[5] = 3*e; r[10] = e/2; r[12] = -3*e;  // m=+2
        r = M + 7*15; r[2] = d; r[7] = -3*d;                       // m=+3: xz(x2-3y2)
        r = M + 8*15; r[0] = c; r[3] = -6*c; r[10] = c;            // m=+4
        break; }
    }
}

// Boys function F_0..F_n(T)
static void boys(int nmax, double T, double* F) {
    if (T < 1e-14) {
        for (int n = 0; n <= nmax; ++n) F[n] = 1.0 / (2*n + 1);
        return;
    }
    if (T > 35.0) {
        F[0] = 0.5 * std::sqrt(PI / T);
        const double eT = (T < 700) ? std::exp(-T) : 0.0;
        for (int n = 0; n < nmax; ++n)
            F[n+1] = ((2*n + 1) * F[n] - eT) / (2 * T);
        return;
    }
    // series for the top order, downward recursion below
    const double eT = std::exp(-T);
    double term = 1.0 / (2*nmax + 1);
    double sum = term;
    for (int i = 1; i < 300; ++i) {
        term *= 2 * T / (2*nmax + 2*i + 1);
        sum += term;
        if (term < 1e-17 * sum) break;
    }
    F[nmax] = eT * sum;
    for (int n = nmax - 1; n >= 0; --n)
        F[n] = (2 * T * F[n+1] + eT) / (2*n + 1);
}

// Hermite expansion coefficients per dimension: E[i][j][t]
struct ETab {
    double e[LMAX+1][LMAX+1][2*LMAX+1];
};

static void etable(int la, int lb, double A, double B, double a, double b,
                   ETab& E) {
    const double p = a + b, mu = a * b / p, Q = A - B;
    std::memset(&E, 0, sizeof(E));
    E.e[0][0][0] = std::exp(-mu * Q * Q);
    for (int i = 1; i <= la; ++i)
        for (int t = 0; t <= i; ++t) {
            double v = 0.0;
            if (t >= 1) v += E.e[i-1][0][t-1] / (2 * p);
            v -= (b / p) * Q * E.e[i-1][0][t];
            if (t + 1 <= i - 1) v += (t + 1) * E.e[i-1][0][t+1];
            E.e[i][0][t] = v;
        }
    for (int j = 1; j <= lb; ++j)
        for (int i = 0; i <= la; ++i)
            for (int t = 0; t <= i + j; ++t) {
                double v = 0.0;
                if (t >= 1) v += E.e[i][j-1][t-1] / (2 * p);
                v += (a / p) * Q * E.e[i][j-1][t];
                if (t + 1 <= i + j - 1) v += (t + 1) * E.e[i][j-1][t+1];
                E.e[i][j][t] = v;
            }
}

// linear index over Hermite (t,u,v) with t+u+v <= L
static inline int tuv_index(int t, int u, int v, int L) {
    // layout: loop t, then u, then v
    int idx = 0;
    for (int tt = 0; tt < t; ++tt) {
        int rem = L - tt;
        idx += (rem + 1) * (rem + 2) / 2;
    }
    int rem = L - t;
    for (int uu = 0; uu < u; ++uu) idx += rem - uu + 1;
    return idx + v;
}
static inline int ntuv(int L) { return (L + 1) * (L + 2) * (L + 3) / 6; }

// shell-pair data: per primitive pair, Hermite representation
struct PairData {
    int la, lb, nprim;            // nprim = npa * npb
    std::vector<double> p;        // (nprim)
    std::vector<double> P;        // (nprim, 3)
    std::vector<double> H;        // (nprim, ntuv(la+lb), ncarta*ncartb)
};

static void build_pair(int la, int lb, const double* Acen, const double* Bcen,
                       const double* aexp, const double* acoef, int na,
                       const double* bexp, const double* bcoef, int nb,
                       PairData& pd) {
    const int L = la + lb;
    const int nab = NCART[la] * NCART[lb];
    const int nh = ntuv(L);
    pd.la = la; pd.lb = lb; pd.nprim = na * nb;
    pd.p.resize(pd.nprim);
    pd.P.resize(pd.nprim * 3);
    pd.H.assign((size_t)pd.nprim * nh * nab, 0.0);
    int pp = 0;
    for (int ia = 0; ia < na; ++ia)
        for (int ib = 0; ib < nb; ++ib, ++pp) {
            const double a = aexp[ia], b = bexp[ib];
            const double cc = acoef[ia] * bcoef[ib];
            const double p = a + b;
            pd.p[pp] = p;
            for (int d = 0; d < 3; ++d)
                pd.P[pp*3 + d] = (a * Acen[d] + b * Bcen[d]) / p;
            ETab Ex, Ey, Ez;
            etable(la, lb, Acen[0], Bcen[0], a, b, Ex);
            etable(la, lb, Acen[1], Bcen[1], a, b, Ey);
            etable(la, lb, Acen[2], Bcen[2], a, b, Ez);
            double* Hp = &pd.H[(size_t)pp * nh * nab];
            for (int ca = 0; ca < NCART[la]; ++ca) {
                const Cart A_ = CARTS[la][ca];
                for (int cb = 0; cb < NCART[lb]; ++cb) {
                    const Cart B_ = CARTS[lb][cb];
                    const int ab = ca * NCART[lb] + cb;
                    for (int t = 0; t <= A_.x + B_.x; ++t)
                        for (int u = 0; u <= A_.y + B_.y; ++u)
                            for (int v = 0; v <= A_.z + B_.z; ++v) {
                                const double val = cc
                                    * Ex.e[A_.x][B_.x][t]
                                    * Ey.e[A_.y][B_.y][u]
                                    * Ez.e[A_.z][B_.z][v];
                                Hp[(size_t)tuv_index(t, u, v, L) * nab + ab] += val;
                            }
                }
            }
        }
}

// R tensor (flattened over tuv with bound L)
static void rtable(int L, double alpha, const double* PQ, double* R /* ntuv(L) */) {
    double F[4*LMAX + 1];
    const double T = alpha * (PQ[0]*PQ[0] + PQ[1]*PQ[1] + PQ[2]*PQ[2]);
    boys(L, T, F);
    // Rn[n][t][u][v] workspace, small fixed bound
    static thread_local std::vector<double> work;
    const int dim = L + 1;
    work.assign((size_t)dim * dim * dim * dim, 0.0);
    auto W = [&](int n, int t, int u, int v) -> double& {
        return work[(((size_t)n * dim + t) * dim + u) * dim + v];
    };
    double m2a = 1.0;
    for (int n = 0; n <= L; ++n) { W(n, 0, 0, 0) = m2a * F[n]; m2a *= -2.0 * alpha; }
    for (int total = 1; total <= L; ++total)
        for (int t = 0; t <= total; ++t)
            for (int u = 0; u <= total - t; ++u) {
                const int v = total - t - u;
                for (int n = 0; n <= L - total; ++n) {
                    double val;
                    if (t > 0) {
                        val = PQ[0] * W(n+1, t-1, u, v);
                        if (t > 1) val += (t - 1) * W(n+1, t-2, u, v);
                    } else if (u > 0) {
                        val = PQ[1] * W(n+1, t, u-1, v);
                        if (u > 1) val += (u - 1) * W(n+1, t, u-2, v);
                    } else {
                        val = PQ[2] * W(n+1, t, u, v-1);
                        if (v > 1) val += (v - 1) * W(n+1, t, u, v-2);
                    }
                    W(n, t, u, v) = val;
                }
            }
    for (int t = 0; t <= L; ++t)
        for (int u = 0; u <= L - t; ++u)
            for (int v = 0; v <= L - t - u; ++v)
                R[tuv_index(t, u, v, L)] = W(0, t, u, v);
}

}  // namespace

extern "C" {

// Compute the full spherical ERI tensor (ij|kl), row-major (nao^4).
//   nshell, l[nshell], nprim[nshell], prim_off[nshell] (into exps/coefs),
//   exps/coefs (flattened primitives), centers (nshell*3),
//   sph_off[nshell] (AO offsets), nao, norms[nao] (final AO normalization),
//   out (nao^4, zero-initialized by the caller)
void compute_eri(int nshell, const int* l, const int* nprim,
                 const int* prim_off, const double* exps, const double* coefs,
                 const double* centers, const int* sph_off, int nao,
                 const double* norms, double* out) {
    // shell pairs (i >= j)
    const int npair = nshell * (nshell + 1) / 2;
    std::vector<PairData> pairs(npair);
    std::vector<int> pi(npair), pj(npair);
    {
        int k = 0;
        for (int i = 0; i < nshell; ++i)
            for (int j = 0; j <= i; ++j, ++k) {
                pi[k] = i; pj[k] = j;
                build_pair(l[i], l[j], centers + 3*i, centers + 3*j,
                           exps + prim_off[i], coefs + prim_off[i], nprim[i],
                           exps + prim_off[j], coefs + prim_off[j], nprim[j],
                           pairs[k]);
            }
    }

    // spherical transform tables
    double c2s[LMAX+1][9*15];
    for (int ll = 0; ll <= LMAX; ++ll) c2s_matrix(ll, c2s[ll]);

    std::vector<double> cart, M, sphbuf, tmp;
    std::vector<double> R;
    const int stride3 = nao, stride2 = nao * nao, stride1 = (size_t)nao * nao * nao;

    // Cauchy-Schwarz screening bounds: Q_P = sqrt(max |(P|P)|) per shell pair
    std::vector<double> Q(npair, 0.0);
    {
        std::vector<double> diagbuf;
        for (int kp = 0; kp < npair; ++kp) {
            const PairData& P = pairs[kp];
            const int Lp = P.la + P.lb;
            const int np_ = NCART[P.la] * NCART[P.lb];
            const int nh = ntuv(Lp);
            const int Lt = 2 * Lp;
            R.resize(ntuv(Lt));
            diagbuf.assign((size_t)np_ * np_, 0.0);
            for (int p1 = 0; p1 < P.nprim; ++p1) {
                const double pb = P.p[p1];
                const double* Pb = &P.P[p1*3];
                const double* H1 = &P.H[(size_t)p1 * nh * np_];
                for (int p2 = 0; p2 < P.nprim; ++p2) {
                    const double pk = P.p[p2];
                    const double* Pk = &P.P[p2*3];
                    const double* H2 = &P.H[(size_t)p2 * nh * np_];
                    const double alpha = pb * pk / (pb + pk);
                    const double PQ[3] = {Pb[0]-Pk[0], Pb[1]-Pk[1], Pb[2]-Pk[2]};
                    const double pref = 2.0 * std::pow(PI, 2.5)
                        / (pb * pk * std::sqrt(pb + pk));
                    rtable(Lt, alpha, PQ, R.data());
                    for (int t1_ = 0; t1_ <= Lp; ++t1_)
                    for (int u1 = 0; u1 <= Lp - t1_; ++u1)
                    for (int v1 = 0; v1 <= Lp - t1_ - u1; ++v1) {
                        const int i1 = tuv_index(t1_, u1, v1, Lp);
                        for (int t2_ = 0; t2_ <= Lp; ++t2_)
                        for (int u2 = 0; u2 <= Lp - t2_; ++u2)
                        for (int v2 = 0; v2 <= Lp - t2_ - u2; ++v2) {
                            const int i2 = tuv_index(t2_, u2, v2, Lp);
                            const double sign = ((t2_ + u2 + v2) & 1) ? -1.0 : 1.0;
                            const double rv = sign * pref
                                * R[tuv_index(t1_+t2_, u1+u2, v1+v2, Lt)];
                            if (rv == 0.0) continue;
                            for (int ab = 0; ab < np_; ++ab)
                                diagbuf[(size_t)ab * np_ + ab] +=
                                    rv * H1[(size_t)i1 * np_ + ab]
                                       * H2[(size_t)i2 * np_ + ab];
                        }
                    }
                }
            }
            double mx = 0.0;
            for (int ab = 0; ab < np_; ++ab)
                mx = std::max(mx, std::fabs(diagbuf[(size_t)ab * np_ + ab]));
            Q[kp] = std::sqrt(mx);
        }
    }
    constexpr double SCREEN_THRESH = 1e-14;

    for (int kb = 0; kb < npair; ++kb) {
        const PairData& B = pairs[kb];
        const int Lb = B.la + B.lb;
        const int nhb = ntuv(Lb);
        const int nab = NCART[B.la] * NCART[B.lb];
        for (int kk = 0; kk <= kb; ++kk) {
            if (Q[kb] * Q[kk] < SCREEN_THRESH) continue;
            const PairData& K = pairs[kk];
            const int Lk = K.la + K.lb;
            const int nhk = ntuv(Lk);
            const int ncd = NCART[K.la] * NCART[K.lb];
            const int Lt = Lb + Lk;
            const int nht = ntuv(Lt);
            cart.assign((size_t)nab * ncd, 0.0);
            M.assign((size_t)nhb * ncd, 0.0);
            R.resize(nht);
            // ket Hermite signs (-1)^(tau+nu+phi)
            for (int ppb = 0; ppb < B.nprim; ++ppb) {
                const double pb = B.p[ppb];
                const double* Pb = &B.P[ppb*3];
                const double* Hb = &B.H[(size_t)ppb * nhb * nab];
                std::fill(M.begin(), M.end(), 0.0);
                bool any = false;
                for (int ppk = 0; ppk < K.nprim; ++ppk) {
                    const double pk = K.p[ppk];
                    const double* Pk = &K.P[ppk*3];
                    const double* Hk = &K.H[(size_t)ppk * nhk * ncd];
                    const double alpha = pb * pk / (pb + pk);
                    const double PQ[3] = {Pb[0]-Pk[0], Pb[1]-Pk[1], Pb[2]-Pk[2]};
                    const double pref = 2.0 * std::pow(PI, 2.5)
                        / (pb * pk * std::sqrt(pb + pk));
                    rtable(Lt, alpha, PQ, R.data());
                    any = true;
                    // M[tuv_b][cd] += pref * sum_{tvu_k} sign * Hk * R
                    for (int tb = 0; tb <= Lb; ++tb)
                    for (int ub = 0; ub <= Lb - tb; ++ub)
                    for (int vb = 0; vb <= Lb - tb - ub; ++vb) {
                        const int ib = tuv_index(tb, ub, vb, Lb);
                        double* Mrow = &M[(size_t)ib * ncd];
                        for (int tk = 0; tk <= Lk; ++tk)
                        for (int uk = 0; uk <= Lk - tk; ++uk)
                        for (int vk = 0; vk <= Lk - tk - uk; ++vk) {
                            const int ik = tuv_index(tk, uk, vk, Lk);
                            const double sign = ((tk + uk + vk) & 1) ? -1.0 : 1.0;
                            const double rv = sign * pref
                                * R[tuv_index(tb+tk, ub+uk, vb+vk, Lt)];
                            if (rv == 0.0) continue;
                            const double* Hrow = &Hk[(size_t)ik * ncd];
                            for (int cd = 0; cd < ncd; ++cd)
                                Mrow[cd] += rv * Hrow[cd];
                        }
                    }
                }
                if (!any) continue;
                // cart[ab][cd] += sum_tuvb Hb[tuv][ab] * M[tuv][cd]
                for (int ih = 0; ih < nhb; ++ih) {
                    const double* Hrow = &Hb[(size_t)ih * nab];
                    const double* Mrow = &M[(size_t)ih * ncd];
                    for (int ab = 0; ab < nab; ++ab) {
                        const double hv = Hrow[ab];
                        if (hv == 0.0) continue;
                        double* crow = &cart[(size_t)ab * ncd];
                        for (int cd = 0; cd < ncd; ++cd)
                            crow[cd] += hv * Mrow[cd];
                    }
                }
            }
            // spherical transform: S = (Ca (x) Cb) cart (Ck (x) Cl)^T
            const int sa = NSPH[B.la], sb = NSPH[B.lb];
            const int sc = NSPH[K.la], sd = NSPH[K.lb];
            const int nab_s = sa * sb, ncd_s = sc * sd;
            tmp.assign((size_t)nab_s * ncd, 0.0);
            // bra transform
            for (int a = 0; a < sa; ++a)
                for (int b = 0; b < sb; ++b) {
                    double* trow = &tmp[(size_t)(a*sb + b) * ncd];
                    for (int ca_ = 0; ca_ < NCART[B.la]; ++ca_) {
                        const double wa = c2s[B.la][a*NCART[B.la] + ca_];
                        if (wa == 0.0) continue;
                        for (int cb_ = 0; cb_ < NCART[B.lb]; ++cb_) {
                            const double w = wa * c2s[B.lb][b*NCART[B.lb] + cb_];
                            if (w == 0.0) continue;
                            const double* crow = &cart[(size_t)(ca_*NCART[B.lb] + cb_) * ncd];
                            for (int cd = 0; cd < ncd; ++cd)
                                trow[cd] += w * crow[cd];
                        }
                    }
                }
            sphbuf.assign((size_t)nab_s * ncd_s, 0.0);
            for (int ab = 0; ab < nab_s; ++ab) {
                const double* trow = &tmp[(size_t)ab * ncd];
                double* srow = &sphbuf[(size_t)ab * ncd_s];
                for (int c = 0; c < sc; ++c)
                    for (int d = 0; d < sd; ++d) {
                        double acc = 0.0;
                        for (int cc_ = 0; cc_ < NCART[K.la]; ++cc_) {
                            const double wc = c2s[K.la][c*NCART[K.la] + cc_];
                            if (wc == 0.0) continue;
                            for (int dd_ = 0; dd_ < NCART[K.lb]; ++dd_) {
                                const double w = wc * c2s[K.lb][d*NCART[K.lb] + dd_];
                                if (w != 0.0)
                                    acc += w * trow[cc_*NCART[K.lb] + dd_];
                            }
                        }
                        srow[c*sd + d] = acc;
                    }
            }
            // normalization + 8-fold scatter
            const int oi = sph_off[pi[kb]], oj = sph_off[pj[kb]];
            const int ok = sph_off[pi[kk]], ol = sph_off[pj[kk]];
            for (int a = 0; a < sa; ++a)
            for (int b = 0; b < sb; ++b)
            for (int c = 0; c < sc; ++c)
            for (int d = 0; d < sd; ++d) {
                const double val = sphbuf[(size_t)(a*sb + b) * ncd_s + c*sd + d]
                    * norms[oi+a] * norms[oj+b] * norms[ok+c] * norms[ol+d];
                const int I = oi + a, J = oj + b, Kc = ok + c, D = ol + d;
                auto put = [&](int w, int x, int y, int z) {
                    out[(size_t)w * stride1 + (size_t)x * stride2 + y * stride3 + z] = val;
                };
                put(I, J, Kc, D); put(J, I, Kc, D);
                put(I, J, D, Kc); put(J, I, D, Kc);
                put(Kc, D, I, J); put(D, Kc, I, J);
                put(Kc, D, J, I); put(D, Kc, J, I);
            }
        }
    }
}

}  // extern "C"

// ---------------------------------------------------------------------------
// One-electron integrals (overlap / kinetic / nuclear attraction / dipole)
//
// Same McMurchie-Davidson machinery as the ERI engine above; replaces the
// role of PySCF's int1e_* (reference exp_pot.py:98-110, utilities.py:
// 1009-1082).  The NumPy implementations in models/integrals.py remain the
// cross-check oracle.
// ---------------------------------------------------------------------------

namespace {

// E table with extended j bound (kinetic needs lb+2)
struct ETab1 {
    double e[LMAX+1][LMAX+3][2*LMAX+5];
};

static void etable1(int la, int lb, double A, double B, double a, double b,
                    ETab1& E) {
    const double p = a + b, mu = a * b / p, Q = A - B;
    std::memset(&E, 0, sizeof(E));
    E.e[0][0][0] = std::exp(-mu * Q * Q);
    for (int i = 1; i <= la; ++i)
        for (int t = 0; t <= i; ++t) {
            double v = 0.0;
            if (t >= 1) v += E.e[i-1][0][t-1] / (2 * p);
            v -= (b / p) * Q * E.e[i-1][0][t];
            if (t + 1 <= i - 1) v += (t + 1) * E.e[i-1][0][t+1];
            E.e[i][0][t] = v;
        }
    for (int j = 1; j <= lb; ++j)
        for (int i = 0; i <= la; ++i)
            for (int t = 0; t <= i + j; ++t) {
                double v = 0.0;
                if (t >= 1) v += E.e[i][j-1][t-1] / (2 * p);
                v += (a / p) * Q * E.e[i][j-1][t];
                if (t + 1 <= i + j - 1) v += (t + 1) * E.e[i][j-1][t+1];
                E.e[i][j][t] = v;
            }
}

}  // namespace

extern "C" {

// kind: 0 = overlap, 1 = kinetic, 2 = nuclear attraction, 3 = dipole
// (3 components about `origin`).  out: (nao,nao) for kinds 0-2, (3,nao,nao)
// for dipole; zero-initialized by the caller.
void compute_int1e(int kind, int nshell, const int* l, const int* nprim,
                   const int* prim_off, const double* exps,
                   const double* coefs, const double* centers,
                   const int* sph_off, int nao, const double* norms,
                   int natm, const double* charges, const double* atm_coords,
                   const double* origin, double* out) {
    double c2s[LMAX+1][9*15];
    for (int ll = 0; ll <= LMAX; ++ll) c2s_matrix(ll, c2s[ll]);
    const int ncomp = (kind == 3) ? 3 : 1;
    std::vector<double> cart, R, sph, tmp;

    for (int i = 0; i < nshell; ++i) {
        const int la = l[i];
        for (int j = 0; j <= i; ++j) {
            const int lb = l[j];
            const int nca = NCART[la], ncb = NCART[lb];
            cart.assign((size_t)ncomp * nca * ncb, 0.0);

            for (int ia = 0; ia < nprim[i]; ++ia)
                for (int ib = 0; ib < nprim[j]; ++ib) {
                    const double a = exps[prim_off[i] + ia];
                    const double b = exps[prim_off[j] + ib];
                    const double cc = coefs[prim_off[i] + ia]
                                    * coefs[prim_off[j] + ib];
                    const double p = a + b;
                    const double* A = centers + 3*i;
                    const double* B = centers + 3*j;
                    double P[3];
                    for (int d = 0; d < 3; ++d)
                        P[d] = (a * A[d] + b * B[d]) / p;
                    const int lb2 = lb + ((kind == 1) ? 2 : 0);
                    ETab1 E[3];
                    for (int d = 0; d < 3; ++d)
                        etable1(la, lb2, A[d], B[d], a, b, E[d]);
                    const double pref = std::pow(PI / p, 1.5);

                    if (kind == 2) {
                        const int Lt = la + lb;
                        R.resize(ntuv(Lt));
                        for (int at = 0; at < natm; ++at) {
                            const double PC[3] = {P[0]-atm_coords[3*at],
                                                  P[1]-atm_coords[3*at+1],
                                                  P[2]-atm_coords[3*at+2]};
                            rtable(Lt, p, PC, R.data());
                            const double zpref = -charges[at] * 2.0 * PI / p * cc;
                            for (int ca = 0; ca < nca; ++ca) {
                                const Cart Ac = CARTS[la][ca];
                                for (int cb = 0; cb < ncb; ++cb) {
                                    const Cart Bc = CARTS[lb][cb];
                                    double acc = 0.0;
                                    for (int t = 0; t <= Ac.x + Bc.x; ++t)
                                    for (int u = 0; u <= Ac.y + Bc.y; ++u)
                                    for (int v = 0; v <= Ac.z + Bc.z; ++v)
                                        acc += E[0].e[Ac.x][Bc.x][t]
                                             * E[1].e[Ac.y][Bc.y][u]
                                             * E[2].e[Ac.z][Bc.z][v]
                                             * R[tuv_index(t, u, v, Lt)];
                                    cart[(size_t)ca * ncb + cb] += zpref * acc;
                                }
                            }
                        }
                        continue;
                    }

                    for (int ca = 0; ca < nca; ++ca) {
                        const Cart Ac = CARTS[la][ca];
                        const int ax[3] = {Ac.x, Ac.y, Ac.z};
                        for (int cb = 0; cb < ncb; ++cb) {
                            const Cart Bc = CARTS[lb][cb];
                            const int bx[3] = {Bc.x, Bc.y, Bc.z};
                            double s0[3];
                            for (int d = 0; d < 3; ++d)
                                s0[d] = E[d].e[ax[d]][bx[d]][0];
                            if (kind == 0) {
                                cart[(size_t)ca * ncb + cb]
                                    += cc * pref * s0[0] * s0[1] * s0[2];
                            } else if (kind == 1) {
                                double K[3];
                                for (int d = 0; d < 3; ++d) {
                                    const int jj = bx[d];
                                    double v = -2.0 * b * b
                                        * E[d].e[ax[d]][jj + 2][0]
                                        + b * (2 * jj + 1) * s0[d];
                                    if (jj >= 2)
                                        v -= 0.5 * jj * (jj - 1)
                                            * E[d].e[ax[d]][jj - 2][0];
                                    K[d] = v;
                                }
                                cart[(size_t)ca * ncb + cb] += cc * pref
                                    * (K[0] * s0[1] * s0[2]
                                       + s0[0] * K[1] * s0[2]
                                       + s0[0] * s0[1] * K[2]);
                            } else {  // dipole: <a| r - origin |b>
                                double s1[3];
                                for (int d = 0; d < 3; ++d) {
                                    const double e1 =
                                        (ax[d] + bx[d] >= 1)
                                            ? E[d].e[ax[d]][bx[d]][1] : 0.0;
                                    s1[d] = e1 + (P[d] - origin[d]) * s0[d];
                                }
                                cart[(size_t)0 * nca * ncb + ca * ncb + cb]
                                    += cc * pref * s1[0] * s0[1] * s0[2];
                                cart[(size_t)1 * nca * ncb + ca * ncb + cb]
                                    += cc * pref * s0[0] * s1[1] * s0[2];
                                cart[(size_t)2 * nca * ncb + ca * ncb + cb]
                                    += cc * pref * s0[0] * s0[1] * s1[2];
                            }
                        }
                    }
                }

            // cartesian -> spherical, normalize, symmetric scatter
            const int nsa = NSPH[la], nsb = NSPH[lb];
            const int oa = sph_off[i], ob = sph_off[j];
            sph.resize((size_t)nsa * nsb);
            tmp.resize((size_t)nsa * ncb);
            for (int comp = 0; comp < ncomp; ++comp) {
                const double* blk = &cart[(size_t)comp * nca * ncb];
                for (int sa = 0; sa < nsa; ++sa)
                    for (int cb = 0; cb < ncb; ++cb) {
                        double v = 0.0;
                        for (int ca = 0; ca < nca; ++ca)
                            v += c2s[la][sa * NCART[la] + ca]
                               * blk[(size_t)ca * ncb + cb];
                        tmp[(size_t)sa * ncb + cb] = v;
                    }
                for (int sa = 0; sa < nsa; ++sa)
                    for (int sb = 0; sb < nsb; ++sb) {
                        double v = 0.0;
                        for (int cb = 0; cb < ncb; ++cb)
                            v += tmp[(size_t)sa * ncb + cb]
                               * c2s[lb][sb * NCART[lb] + cb];
                        sph[(size_t)sa * nsb + sb] =
                            v * norms[oa + sa] * norms[ob + sb];
                    }
                double* o = out + (size_t)comp * nao * nao;
                for (int sa = 0; sa < nsa; ++sa)
                    for (int sb = 0; sb < nsb; ++sb) {
                        o[(size_t)(oa + sa) * nao + (ob + sb)] =
                            sph[(size_t)sa * nsb + sb];
                        o[(size_t)(ob + sb) * nao + (oa + sa)] =
                            sph[(size_t)sa * nsb + sb];
                    }
            }
        }
    }
}

}  // extern "C"
