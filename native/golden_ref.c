/* golden_ref.c — native exact-parity engine for polardecoding_tpu.
 *
 * A fresh, array-based C implementation of the reference semantics
 * (CHEBSB/PolarDecoding; see SURVEY.md) used for two things:
 *
 *   1. GOLDEN MODE: reproduce the C reference's Monte-Carlo runs
 *      frame-for-frame at matched seeds (same Ranq1 xorshift-multiply PRNG,
 *      Marsaglia-polar noise stream consumed pairwise, PN payload windows,
 *      float64 LUT-corrected min-sum with the reference's exact operation
 *      association) at native speed, so parity tests can cover thousands of
 *      frames instead of a handful.
 *
 *   2. CPU BASELINE: the reference publishes no throughput numbers
 *      (SURVEY §6); this engine measured on one core is the
 *      "reference-class" baseline for the JAX engines.
 *
 * Design is deliberately NOT the reference's: no pointer factor graph, no
 * per-node structs — dense (n+1) x N message arrays for BP (same layout as
 * the JAX engine) and the compact O(N) slot schedule for SC (same layout as
 * models/_compact.py).  Only the *semantics* (update equations, table
 * constants, PRNG stream, operation association) mirror the reference, with
 * citations in comments.
 *
 * Exposed as a small C ABI for ctypes (see polardecoding_tpu/native.py).
 */
#include <math.h>
#include <stdint.h>
#include <stdlib.h>
#include <string.h>

/* ---------------- PRNG: Ranq1 + Marsaglia polar (SC_128.c:235-267) ------- */

typedef struct {
  uint64_t v;
  double n2;      /* second cached normal */
  int have_n2;
} rng_t;

static void rng_init(rng_t *r, uint64_t seed) {
  uint64_t v = seed ^ 4101842887655102017ULL;
  v ^= v >> 21;
  v ^= v << 35;
  v ^= v >> 4;
  r->v = v * 2685821657736338717ULL;
  r->have_n2 = 0;
  r->n2 = 0.0;
}

static double rng_uniform(rng_t *r) {
  r->v ^= r->v >> 21;
  r->v ^= r->v << 35;
  r->v ^= r->v >> 4;
  return (double)(r->v * 2685821657736338717ULL) * 5.42101086242752217E-20;
}

/* two sigma-scaled normals per call, polar method with rejection */
static void rng_normal_pair(rng_t *r, double sigma, double *a, double *b) {
  double x1, x2, s;
  do {
    x1 = 2 * rng_uniform(r) - 1;
    x2 = 2 * rng_uniform(r) - 1;
    s = x1 * x1 + x2 * x2;
  } while (s >= 1.0);
  double f = sqrt(-2 * log(s) / s);
  *a = sigma * x1 * f;
  *b = sigma * x2 * f;
}

/* ---------------- PN payload source (SC_128.c:125-138) ------------------- */

static void pn_sequence(int pn[63]) {
  int state[6] = {0, 0, 0, 0, 0, 0};
  for (int i = 0; i < 63; i++) {
    int b;
    if (i == 0) b = 1;
    else if (i < 6) b = 0;
    else b = state[4] ^ state[5];
    pn[i] = b;
    for (int k = 5; k > 0; k--) state[k] = state[k - 1];
    state[0] = b;
  }
}

/* ---------------- CHK: table-corrected min-sum (BP_128.c:273-305) -------- */

static double lutc(double x) {
  if (x < 0.196) return 0.65;
  if (x < 0.433) return 0.55;
  if (x < 0.71) return 0.45;
  if (x < 1.05) return 0.35;
  if (x < 1.508) return 0.25;
  if (x < 2.252) return 0.15;
  if (x < 4.5) return 0.05;
  return 0.0;
}

static double chk(double a, double b) {
  /* delta formed first, then added — the reference's exact association */
  double delta = lutc(fabs(a + b)) - lutc(fabs(a - b));
  double m = fabs(a) < fabs(b) ? fabs(a) : fabs(b);
  int s = ((a >= 0) == (b >= 0)) ? 1 : -1;
  return s * m + delta;
}

/* ---------------- butterfly encoder (O(N log N)) ------------------------- */

static void polar_encode(int8_t *x, int N) {
  /* Lee convention: stage-i pairs at distance 2^i, upper ^= lower
     (equivalent to x = u . F^{tensor n}; ref encodes via dense Fn rows,
     SC_128.c:182-191) */
  for (int d = 1; d < N; d <<= 1)
    for (int j = 0; j < N; j++)
      if (!(j & d)) x[j] ^= x[j + d];
}

/* ---------------- BP decoder (BP_128.c:334-389) -------------------------- */

static void bp_decode(int N, int n, const double *ch_llr,
                      const uint8_t *frozen, int iters, double *L, double *R,
                      int8_t *u_hat) {
  /* L, R: caller-provided (n+1) x N scratch */
  memset(L, 0, sizeof(double) * (size_t)n * N);
  memcpy(L + (size_t)n * N, ch_llr, sizeof(double) * N);
  memset(R + N, 0, sizeof(double) * (size_t)n * N);
  for (int j = 0; j < N; j++) R[j] = frozen[j] ? 999.0 : 0.0;

  for (int it = 0; it < iters; it++) {
    for (int i = 0; i < n; i++) {   /* R-sweep, Gauss-Seidel over stages */
      const double *Ri = R + (size_t)i * N;
      double *Rn = R + (size_t)(i + 1) * N;
      const double *Ln = L + (size_t)(i + 1) * N;
      int d = 1 << i;
      for (int j = 0; j < N; j++)
        if (!(j & d)) {
          Rn[j] = chk(Ri[j], Ln[j + d] + Ri[j + d]);
          Rn[j + d] = Ri[j + d] + chk(Ri[j], Ln[j]);
        }
    }
    for (int i = n - 1; i >= 0; i--) {   /* L-sweep */
      const double *Ri = R + (size_t)i * N;
      double *Li = L + (size_t)i * N;
      const double *Ln = L + (size_t)(i + 1) * N;
      int d = 1 << i;
      for (int j = 0; j < N; j++)
        if (!(j & d)) {
          Li[j] = chk(Ln[j], Ln[j + d] + Ri[j + d]);
          Li[j + d] = Ln[j + d] + chk(Ri[j], Ln[j]);
        }
    }
  }
  for (int j = 0; j < N; j++)
    u_hat[j] = frozen[j] ? 0 : ((L[j] + R[j] >= 0) ? 0 : 1);
}

/* ---------------- SC decoder: compact O(N) schedule ---------------------- */
/* Same algorithm as models/_compact.py: slot i (size 2^i, offset 2^i - 1)
   holds the current stage-i group; recursion/memoization of the reference
   (SC_128.c:344-392) replaced by the ntz schedule. */

static void sc_decode(int N, int n, const double *ch_llr,
                      const uint8_t *frozen, double *llr_c, int8_t *bits_c,
                      int8_t *v /* scratch, length N */, int8_t *u_hat) {
  for (int j = 0; j < N; j++) {
    int t = (j == 0) ? n : __builtin_ctz(j);
    /* g-update at stage t (lower half), then f-updates down to stage 0 */
    if (t < n) {
      int w = 1 << t;
      const double *src = (t + 1 == n) ? ch_llr : llr_c + (2 * w - 1);
      double *dst = llr_c + (w - 1);
      const int8_t *pb = bits_c + (w - 1);
      for (int m = 0; m < w; m++)
        dst[m] = src[w + m] + (pb[m] ? -src[m] : src[m]);
    }
    for (int i = t - 1; i >= 0; i--) {
      int w = 1 << i;
      const double *src = (i + 1 == n) ? ch_llr : llr_c + (2 * w - 1);
      double *dst = llr_c + (w - 1);
      for (int m = 0; m < w; m++) dst[m] = chk(src[m], src[w + m]);
    }
    int8_t u = frozen[j] ? 0 : (llr_c[0] < 0 ? 1 : 0);
    u_hat[j] = u;
    /* partial-sum combine through ntz(j+1) stages: v' = [slot ^ v, v] */
    int t1 = __builtin_ctz(j + 1);
    if (t1 > n) t1 = n;
    v[0] = u;
    int w = 1;
    for (int i = 0; i < t1; i++) {
      const int8_t *slot = bits_c + (w - 1);
      for (int m = w - 1; m >= 0; m--) v[w + m] = v[m]; /* v -> lower half */
      for (int m = 0; m < w; m++) v[m] = (int8_t)(slot[m] ^ v[w + m]);
      w <<= 1;
    }
    if (t1 < n) memcpy(bits_c + (w - 1), v, (size_t)w);
  }
}

/* ---------------- SCL / CA-SCL decoder ----------------------------------- */
/* Same algorithm as the JAX engines (models/scl.py, validated frame-for-frame
   against the reference's SCL_1024.c semantics by the golden fixtures):
   compact O(N) slot state per path, inactive paths at PM = BIG, and 2L -> L
   selection keeping the L smallest candidates with ties broken by candidate
   index (cand[k] = PM[k] + PHI(l,0), cand[k+L] = PM[k] + PHI(l,1) — the
   reference's scan order).  PHI table: SCL_1024.c:481-502. */

#define SCL_BIG 1e30

static double phi_pen(double l, int u) {
  double res = lutc(fabs(l));
  if ((u == 0 && l < 0) || (u == 1 && l > 0)) res += fabs(l);
  return res;
}

typedef struct {
  int N, n, L;
  double *llr;   /* [L][N-1] compact slots */
  int8_t *bits;  /* [L][N-1] */
  int8_t *u;     /* [L][N]  decisions */
  double *pm;    /* [L] */
  double *tl;    /* tmp llr  [L][N-1] */
  int8_t *tb;    /* tmp bits [L][N-1] */
  int8_t *tu;    /* tmp u    [L][N] */
  int8_t *v;     /* combine scratch [N] */
} scl_t;

static void scl_llr_phase(scl_t *s, const double *ch, int p, int t) {
  int N = s->N, n = s->n;
  double *lc = s->llr + (size_t)p * (N - 1);
  int8_t *bc = s->bits + (size_t)p * (N - 1);
  if (t < n) {
    int w = 1 << t;
    const double *src = (t + 1 == n) ? ch : lc + (2 * w - 1);
    const int8_t *pb = bc + (w - 1);
    double *dst = lc + (w - 1);
    for (int m = 0; m < w; m++)
      dst[m] = src[w + m] + (pb[m] ? -src[m] : src[m]);
  }
  for (int i = t - 1; i >= 0; i--) {
    int w = 1 << i;
    const double *src = (i + 1 == n) ? ch : lc + (2 * w - 1);
    double *dst = lc + (w - 1);
    for (int m = 0; m < w; m++) dst[m] = chk(src[m], src[w + m]);
  }
}

static void scl_bit_phase(scl_t *s, int p, int j, int8_t u) {
  int n = s->n;
  int8_t *bc = s->bits + (size_t)p * (s->N - 1);
  int t1 = __builtin_ctz(j + 1);
  if (t1 > n) t1 = n;
  int8_t *v = s->v;
  v[0] = u;
  int w = 1;
  for (int i = 0; i < t1; i++) {
    const int8_t *slot = bc + (w - 1);
    for (int m = w - 1; m >= 0; m--) v[w + m] = v[m];
    for (int m = 0; m < w; m++) v[m] = (int8_t)(slot[m] ^ v[w + m]);
    w <<= 1;
  }
  if (t1 < n) memcpy(bc + (w - 1), v, (size_t)w);
}

static void scl_decode(scl_t *s, const double *ch, const uint8_t *frozen) {
  int N = s->N, n = s->n, L = s->L;
  size_t ns = (size_t)(N - 1);
  memset(s->llr, 0, sizeof(double) * ns * L);
  memset(s->bits, 0, ns * L);
  memset(s->u, 0, (size_t)N * L);
  s->pm[0] = 0.0;
  for (int p = 1; p < L; p++) s->pm[p] = SCL_BIG;

  for (int j = 0; j < N; j++) {
    int t = (j == 0) ? n : __builtin_ctz(j);
    for (int p = 0; p < L; p++) scl_llr_phase(s, ch, p, t);
    if (frozen[j]) {
      for (int p = 0; p < L; p++) {
        double l0 = s->llr[(size_t)p * ns];
        s->pm[p] += phi_pen(l0, 0);
        s->u[(size_t)p * N + j] = 0;
        scl_bit_phase(s, p, j, 0);
      }
    } else {
      double cand[2 * 64];
      for (int p = 0; p < L; p++) {
        double l0 = s->llr[(size_t)p * ns];
        cand[p] = s->pm[p] + phi_pen(l0, 0);
        cand[p + L] = s->pm[p] + phi_pen(l0, 1);
      }
      /* rank-k candidate per destination slot: stable (value, index) order */
      int order[2 * 64];
      for (int i = 0; i < 2 * L; i++) order[i] = i;
      for (int a = 1; a < 2 * L; a++) { /* insertion sort, stable */
        int key = order[a];
        int b = a - 1;
        while (b >= 0 && cand[order[b]] > cand[key]) {
          order[b + 1] = order[b];
          b--;
        }
        order[b + 1] = key;
      }
      memcpy(s->tl, s->llr, sizeof(double) * ns * L);
      memcpy(s->tb, s->bits, ns * L);
      memcpy(s->tu, s->u, (size_t)N * L);
      for (int k = 0; k < L; k++) {
        int idx = order[k];
        int parent = idx % L;
        int8_t ub = (int8_t)(idx >= L);
        memcpy(s->llr + (size_t)k * ns, s->tl + (size_t)parent * ns,
               sizeof(double) * ns);
        memcpy(s->bits + (size_t)k * ns, s->tb + (size_t)parent * ns, ns);
        memcpy(s->u + (size_t)k * N, s->tu + (size_t)parent * N, (size_t)N);
        s->pm[k] = cand[idx];
        s->u[(size_t)k * N + j] = ub;
        scl_bit_phase(s, k, j, ub);
      }
    }
  }
}

/* CRC long division check over extracted bits (CASCL_128.c:517-536 shape,
   generic taps).  bits: [len] with coefficient index == exponent. */
static int crc_passes(const int8_t *bits, int len, const int32_t *exps,
                      int nexp) {
  int r = 0;
  for (int e = 0; e < nexp; e++)
    if (exps[e] > r) r = exps[e];
  int8_t C[4096];
  memcpy(C, bits, (size_t)len);
  for (int i = len - 1; i >= r; i--)
    if (C[i]) {
      for (int e = 0; e < nexp; e++) C[i - r + exps[e]] ^= 1;
    }
  for (int i = 0; i < r; i++)
    if (C[i]) return 0;
  return 1;
}

/* ---------------- public ABI --------------------------------------------- */

/* exact noise stream: one normal() per two positions (SC_128.c:192-202) */
void pd_golden_noise(uint64_t seed, int nframes, int N, double sigma,
                     double *out) {
  rng_t r;
  rng_init(&r, seed);
  for (int f = 0; f < nframes; f++)
    for (int i = 0; i < N; i += 2) {
      double a, b;
      rng_normal_pair(&r, sigma, &a, &b);
      out[(size_t)f * N + i] = a;
      if (i + 1 < N) out[(size_t)f * N + i + 1] = b;
    }
}

/* SCL / CA-SCL Monte-Carlo at matched seeds.  KI = number of info channels
   (K payload + CRC degree for CA-SCL; == K for plain SCL).  crc_exps/n_crc:
   multiplicative CRC generator exponents (NULL/0 for plain SCL).
   u_hat_out (optional): [nframes][KI] decoded info word of the selected path. */
void pd_golden_mc_list(int N, int K, int KI, const int32_t *info_set,
                       const int32_t *crc_exps, int n_crc, uint64_t seed,
                       double snr_db, int nframes, int L, int64_t *errbit,
                       int64_t *errblock, int8_t *u_hat_out) {
  int n = 0;
  while ((1 << n) < N) n++;
  double sigma = pow(10.0, snr_db / -20.0);
  uint8_t *frozen = calloc(N, 1);
  int8_t *w = calloc(KI, 1);
  int8_t *u = malloc(N);
  int8_t *x = malloc(N);
  double *y = malloc(sizeof(double) * N);
  double *llr = malloc(sizeof(double) * N);
  int8_t *cw = malloc(KI);
  int pn[63];
  pn_sequence(pn);

  scl_t s;
  s.N = N; s.n = n; s.L = L;
  s.llr = malloc(sizeof(double) * (size_t)(N - 1) * L);
  s.bits = malloc((size_t)(N - 1) * L);
  s.u = malloc((size_t)N * L);
  s.pm = malloc(sizeof(double) * L);
  s.tl = malloc(sizeof(double) * (size_t)(N - 1) * L);
  s.tb = malloc((size_t)(N - 1) * L);
  s.tu = malloc((size_t)N * L);
  s.v = malloc(N);

  for (int j = 0; j < N; j++) frozen[j] = 1;
  for (int i = 0; i < KI; i++) frozen[info_set[i]] = 0;

  rng_t r;
  rng_init(&r, seed);
  int m = 0, step_m = K % 63;
  int64_t eb = 0, ebl = 0;

  for (int f = 0; f < nframes; f++) {
    /* payload + optional multiplicative CRC encode (CASCL_128.c:205-220) */
    memset(w, 0, (size_t)KI);
    for (int i = 0; i < K; i++)
      if (pn[(m + i) % 63])
        for (int e = 0; e < (n_crc ? n_crc : 1); e++)
          w[i + (n_crc ? crc_exps[e] : 0)] ^= 1;
    memset(u, 0, (size_t)N);
    for (int i = 0; i < KI; i++) u[info_set[i]] = w[i];
    memcpy(x, u, (size_t)N);
    polar_encode(x, N);
    for (int i = 0; i < N; i += 2) {
      double a, b;
      rng_normal_pair(&r, sigma, &a, &b);
      y[i] = (x[i] ? -1.0 : 1.0) + a;
      if (i + 1 < N) y[i + 1] = (x[i + 1] ? -1.0 : 1.0) + b;
    }
    for (int j = 0; j < N; j++) llr[j] = 2 * y[j] / sigma / sigma;

    scl_decode(&s, llr, frozen);

    /* selection: min-PM among CRC passers, else global min-PM
       (CASCL_128.c:663-698) */
    int best = -1;
    if (n_crc) {
      for (int p = 0; p < L; p++) {
        for (int i = 0; i < KI; i++) cw[i] = s.u[(size_t)p * N + info_set[i]];
        if (crc_passes(cw, KI, crc_exps, n_crc))
          if (best < 0 || s.pm[p] < s.pm[best]) best = p;
      }
    }
    if (best < 0) {
      best = 0;
      for (int p = 1; p < L; p++)
        if (s.pm[p] < s.pm[best]) best = p;
    }
    int bad = 0;
    for (int i = 0; i < KI; i++) {
      int8_t got = s.u[(size_t)best * N + info_set[i]];
      if (got != w[i]) { bad = 1; eb++; }
      if (u_hat_out) u_hat_out[(size_t)f * KI + i] = got;
    }
    ebl += bad;
    m += step_m;
    if (m >= 63) m -= 63;
  }
  *errbit = eb;
  *errblock = ebl;
  free(frozen); free(w); free(u); free(x); free(y); free(llr); free(cw);
  free(s.llr); free(s.bits); free(s.u); free(s.pm);
  free(s.tl); free(s.tb); free(s.tu); free(s.v);
}

/* Monte-Carlo run mirroring the reference main() loop at matched seeds:
   decoder 0 = BP(iters), 1 = SC.  info_set: K info positions ascending-Q
   order (payload bit i goes to u[info_set[i]]; ref SC_128.c:179-181).
   Returns errbit/errblock counted over the K info positions, and optionally
   the decoded info bits per frame (u_hat_out, nframes x K, may be NULL). */
void pd_golden_mc(int N, int K, const int32_t *info_set, uint64_t seed,
                  double snr_db, int nframes, int decoder, int iters,
                  int64_t *errbit, int64_t *errblock, int8_t *u_hat_out) {
  int n = 0;
  while ((1 << n) < N) n++;
  double sigma = pow(10.0, snr_db / -20.0);
  uint8_t *frozen = calloc(N, 1);
  int8_t *u = malloc(N);
  int8_t *x = malloc(N);
  double *y = malloc(sizeof(double) * N);
  double *llr = malloc(sizeof(double) * N);
  int8_t *u_hat = malloc(N);
  double *L = malloc(sizeof(double) * (size_t)(n + 1) * N);
  double *R = malloc(sizeof(double) * (size_t)(n + 1) * N);
  double *llr_c = malloc(sizeof(double) * N);
  int8_t *bits_c = malloc(N);
  int8_t *vtmp = malloc(N);
  int pn[63];
  pn_sequence(pn);

  for (int j = 0; j < N; j++) frozen[j] = 1;
  for (int i = 0; i < K; i++) frozen[info_set[i]] = 0;

  rng_t r;
  rng_init(&r, seed);
  int m = 0, step_m = K % 63;
  int64_t eb = 0, ebl = 0;

  for (int f = 0; f < nframes; f++) {
    memset(u, 0, N);
    for (int i = 0; i < K; i++) u[info_set[i]] = (int8_t)pn[(m + i) % 63];
    memcpy(x, u, N);
    polar_encode(x, N);
    for (int i = 0; i < N; i += 2) {  /* BPSK + pairwise noise */
      double a, b;
      rng_normal_pair(&r, sigma, &a, &b);
      y[i] = (x[i] ? -1.0 : 1.0) + a;
      if (i + 1 < N) y[i + 1] = (x[i + 1] ? -1.0 : 1.0) + b;
    }
    for (int j = 0; j < N; j++) llr[j] = 2 * y[j] / sigma / sigma;
    if (decoder == 0)
      bp_decode(N, n, llr, frozen, iters, L, R, u_hat);
    else {
      memset(llr_c, 0, sizeof(double) * N);
      memset(bits_c, 0, N);
      sc_decode(N, n, llr, frozen, llr_c, bits_c, vtmp, u_hat);
    }
    int bad = 0;
    for (int i = 0; i < K; i++) {
      int p = info_set[i];
      if (u[p] != u_hat[p]) { bad = 1; eb++; }
      if (u_hat_out) u_hat_out[(size_t)f * K + i] = u_hat[p];
    }
    ebl += bad;
    m += step_m;
    if (m >= 63) m -= 63;
  }
  *errbit = eb;
  *errblock = ebl;
  free(frozen); free(u); free(x); free(y); free(llr); free(u_hat);
  free(L); free(R); free(llr_c); free(bits_c); free(vtmp);
}
