/* Host runtime of sz_tpu_torch: the strictly serial host stages of the
 * regression codec, in C where Python would dominate the wall clock.
 * Copied from sz_tpu/native/core.c (same arithmetic, same order):
 *   - ordered float and double accumulation (C `acc += x`;
 *     sz_float.c:6658-6669)
 *   - the coefficient delta-quantization chain and its decode, in float
 *     and in double (sz_float.c:6787-6814, szd_float.c:3376-3414;
 *     sz_double.c / szd_double.c)
 *   - the reference-exact Huffman tree build (Huffman.c:76-185, 443-585)
 *   - the PW_REL/MSST19 host stages: the exact-value escape stream and
 *     its decode (dataCompression.c:575, CompressElement.c:230,
 *     szd_float.c:185), the range/sign scan (dataCompression.c:121),
 *     the cache-table build (MultiLevelCacheTableWideInterval.c:47-186)
 *     and the fixed-width bit pack (TypeManager.c:377)
 *   - the classic (SZ1.4) 1-D codec in float and double, and the 1-D
 *     MSST19 codec in float: serial recurrences, host-only as in the
 *     JAX package (sz_float.c:353, sz_double.c:260, szd_float.c:185;
 *     sz_float.c MSST19 1-D, szd_float.c decompressDataSeries_float_1D_
 *     MSST19)
 *   - glibc log2/exp2 per element, the pre-log PW_REL transform
 *     (sz_float_pwr.c:1792-1860): numpy's SIMD forms differ in the last
 *     ulp, and double streams serialize these values
 *   - the double forms of the range/sign scan and of the 1-D MSST19
 *     codec (sz_double.c MSST19 1-D, szd_double.c)
 *   - the random-access codec's host stages: its coefficient chain and
 *     decode (sz_float.c:9677-9712), the per-block Huffman streams with
 *     one shared table and their decode (sz_float.c:10020-10050,
 *     szd_float.c:7213), and the 1-D integer codec of the nested
 *     streams (SZ_compress_int32_1D_MDQ sz_int32.c:228, sz_uint16.c;
 *     their decoders)
 *
 * Built with `cc -O3 -ffp-contract=off` (no FMA contraction, no
 * -march, no fast-math) by sz_tpu_torch/native/__init__.py; bound with
 * ctypes.
 */

#include <stdint.h>
#include <stdlib.h>
#include <math.h>
#include <string.h>

float seq_sum_f32(const float *x, int64_t n) {
    float acc = 0.0f;
    for (int64_t i = 0; i < n; i++) acc += x[i];
    return acc;
}

double seq_sum_f64(const double *x, int64_t n) {
    double acc = 0.0;
    for (int64_t i = 0; i < n; i++) acc += x[i];
    return acc;
}

/* For each reg block (rows of coeffs[nreg][nc]), quantize each coeff
 * against the previous reconstructed value.  Outputs:
 *   ctypes[nc][nreg]   type codes
 *   unpred[nc][nreg]   escape values (compacted per coeff; counts out)
 *   qcoeffs[nreg][nc]  reconstructed coefficients
 * use_mean selects the multiply-by-reciprocal form (sz_float.c:6699). */
void coeff_chain_f32(const float *coeffs, int64_t nreg, int nc,
                     const float *precision, int use_mean,
                     int32_t *ctypes, float *unpred, int64_t *unpred_cnt,
                     float *qcoeffs, int capacity, int radius) {
    float last[8] = {0};
    float recip[8];
    for (int e = 0; e < nc; e++) {
        recip[e] = 1.0f / precision[e];
        unpred_cnt[e] = 0;
    }
    float cap = (float)capacity;
    for (int64_t n = 0; n < nreg; n++) {
        for (int e = 0; e < nc; e++) {
            float cur = coeffs[n * nc + e];
            float diff = cur - last[e];
            float itv = use_mean ? fabsf(diff) * recip[e] + 1.0f
                                 : fabsf(diff) / precision[e] + 1.0f;
            int32_t t = 0;
            if (itv < cap) {
                if (diff < 0) itv = -itv;
                t = (int32_t)(itv / 2.0f) + radius;
                float rec = last[e] + (float)(2 * (t - radius)) * precision[e];
                if (fabsf(cur - rec) > precision[e]) {
                    t = 0;
                    last[e] = cur;
                    unpred[e * nreg + unpred_cnt[e]++] = cur;
                } else {
                    last[e] = rec;
                }
            } else {
                last[e] = cur;
                unpred[e * nreg + unpred_cnt[e]++] = cur;
            }
            ctypes[e * nreg + n] = t;
            qcoeffs[n * nc + e] = last[e];
        }
    }
}

void coeff_chain_f64(const double *coeffs, int64_t nreg, int nc,
                     const double *precision, int use_mean,
                     int32_t *ctypes, double *unpred, int64_t *unpred_cnt,
                     double *qcoeffs, int capacity, int radius) {
    double last[8] = {0};
    double recip[8];
    for (int e = 0; e < nc; e++) {
        recip[e] = 1.0 / precision[e];
        unpred_cnt[e] = 0;
    }
    double cap = (double)capacity;
    for (int64_t n = 0; n < nreg; n++) {
        for (int e = 0; e < nc; e++) {
            double cur = coeffs[n * nc + e];
            double diff = cur - last[e];
            double itv = use_mean ? fabs(diff) * recip[e] + 1.0
                                  : fabs(diff) / precision[e] + 1.0;
            int32_t t = 0;
            if (itv < cap) {
                if (diff < 0) itv = -itv;
                t = (int32_t)(itv / 2.0) + radius;
                double rec = last[e] + (double)(2 * (t - radius)) * precision[e];
                if (fabs(cur - rec) > precision[e]) {
                    t = 0;
                    last[e] = cur;
                    unpred[e * nreg + unpred_cnt[e]++] = cur;
                } else {
                    last[e] = rec;
                }
            } else {
                last[e] = cur;
                unpred[e * nreg + unpred_cnt[e]++] = cur;
            }
            ctypes[e * nreg + n] = t;
            qcoeffs[n * nc + e] = last[e];
        }
    }
}

/* Decode side of the chain (szd_float.c:3376-3414). */
void coeff_chain_decode_f32(const int32_t *ctypes, int64_t nreg, int nc,
                            const float *precision, const int32_t *cradius,
                            const float *unpred, const int64_t *stride,
                            float *qcoeffs) {
    float last[8] = {0};
    int64_t ucnt[8] = {0};
    for (int64_t n = 0; n < nreg; n++) {
        for (int e = 0; e < nc; e++) {
            int32_t t = ctypes[e * nreg + n];
            if (t != 0)
                last[e] = last[e] + (float)(2 * (t - cradius[e])) * precision[e];
            else
                last[e] = unpred[e * stride[0] + ucnt[e]++];
            qcoeffs[n * nc + e] = last[e];
        }
    }
}

void coeff_chain_decode_f64(const int32_t *ctypes, int64_t nreg, int nc,
                            const double *precision, const int32_t *cradius,
                            const double *unpred, const int64_t *stride,
                            double *qcoeffs) {
    double last[8] = {0};
    int64_t ucnt[8] = {0};
    for (int64_t n = 0; n < nreg; n++) {
        for (int e = 0; e < nc; e++) {
            int32_t t = ctypes[e * nreg + n];
            if (t != 0)
                last[e] = last[e] + (double)(2 * (t - cradius[e])) * precision[e];
            else
                last[e] = unpred[e * stride[0] + ucnt[e]++];
            qcoeffs[n * nc + e] = last[e];
        }
    }
}

/* ------------------------------------------------------------------ */
/* Huffman tree construction: exact replica of the reference algorithm */
/* (1-indexed non-stable min-heap, creation-order node ids, gcc        */
/* right-to-left argument evaluation making the first removal the      */
/* RIGHT child, preorder pad/serialize).                               */
/* ------------------------------------------------------------------ */

typedef struct {
    int64_t *slots;
    int64_t *freqs;
    int64_t qend;
} hheap;

static void hheap_insert(hheap *h, int64_t node_id, int64_t freq) {
    int64_t i = h->qend++;
    while (1) {
        int64_t j = i >> 1;
        if (j == 0 || h->freqs[j] <= freq) break;
        h->slots[i] = h->slots[j];
        h->freqs[i] = h->freqs[j];
        i = j;
    }
    h->slots[i] = node_id;
    h->freqs[i] = freq;
}

static int64_t hheap_remove(hheap *h) {
    int64_t n = h->slots[1];
    if (h->qend < 2) return -1;
    h->qend--;
    int64_t qend = h->qend;
    h->slots[1] = h->slots[qend];
    h->freqs[1] = h->freqs[qend];
    int64_t i = 1;
    while (1) {
        int64_t l = i << 1;
        if (l >= qend) break;
        if (l + 1 < qend && h->freqs[l + 1] < h->freqs[l]) l++;
        if (h->freqs[i] > h->freqs[l]) {
            int64_t ts = h->slots[i]; h->slots[i] = h->slots[l]; h->slots[l] = ts;
            int64_t tf = h->freqs[i]; h->freqs[i] = h->freqs[l]; h->freqs[l] = tf;
            i = l;
        } else break;
    }
    return n;
}

/* Build tree + assign codes + preorder-serialize.  freq: int64[freq_len];
 * code_*: [state_num]; L/R/C/T: [node_count] with node_count=2*nnz-1
 * precomputed by the caller.  Returns node_count, or -1 if nnz < 1. */
int64_t huff_build_tree(const int64_t *freq, int64_t freq_len,
                        int64_t state_num,
                        uint64_t *code_hi, uint64_t *code_lo,
                        uint8_t *code_len,
                        uint32_t *L, uint32_t *R, uint32_t *C, uint8_t *T) {
    int64_t nnz = 0;
    for (int64_t s = 0; s < freq_len; s++) if (freq[s]) nnz++;
    if (nnz < 1) return -1;
    int64_t max_nodes = 2 * nnz + 2;
    int64_t *left  = malloc(max_nodes * sizeof(int64_t));
    int64_t *right = malloc(max_nodes * sizeof(int64_t));
    int64_t *sym   = malloc(max_nodes * sizeof(int64_t));
    uint8_t *leaf  = calloc(max_nodes, 1);
    int64_t *nfreq = malloc(max_nodes * sizeof(int64_t));
    hheap h;
    h.slots = calloc(max_nodes + 2, sizeof(int64_t));
    h.freqs = calloc(max_nodes + 2, sizeof(int64_t));
    h.qend = 1;
    int64_t n_nodes = 0;
    for (int64_t s = 0; s < freq_len; s++) {
        if (!freq[s]) continue;
        left[n_nodes] = -1; right[n_nodes] = -1;
        sym[n_nodes] = s; leaf[n_nodes] = 1; nfreq[n_nodes] = freq[s];
        hheap_insert(&h, n_nodes, freq[s]);
        n_nodes++;
    }
    while (h.qend > 2) {
        int64_t b = hheap_remove(&h);   /* first removed -> RIGHT child */
        int64_t a = hheap_remove(&h);
        left[n_nodes] = a; right[n_nodes] = b;
        leaf[n_nodes] = 0; sym[n_nodes] = 0;
        int64_t f = nfreq[a] + nfreq[b];
        nfreq[n_nodes] = f;
        hheap_insert(&h, n_nodes, f);
        n_nodes++;
    }
    int64_t root = h.slots[1];

    /* code assignment (build_code, Huffman.c:122-157) */
    for (int64_t s = 0; s < state_num; s++) {
        code_hi[s] = 0; code_lo[s] = 0; code_len[s] = 0;
    }
    int64_t cap = n_nodes + 4;
    int64_t *st_n = malloc(cap * sizeof(int64_t));
    int     *st_l = malloc(cap * sizeof(int));
    uint64_t *st_1 = malloc(cap * sizeof(uint64_t));
    uint64_t *st_2 = malloc(cap * sizeof(uint64_t));
    int64_t sp = 0;
    st_n[sp] = root; st_l[sp] = 0; st_1[sp] = 0; st_2[sp] = 0; sp++;
    while (sp > 0) {
        sp--;
        int64_t n = st_n[sp];
        int ln = st_l[sp];
        uint64_t o1 = st_1[sp], o2 = st_2[sp];
        if (leaf[n]) {
            int64_t s = sym[n];
            if (s >= state_num) continue;  /* symbol outside the table */
            if (ln <= 64) {
                code_hi[s] = ln ? (o1 << (64 - ln)) : 0;
                code_lo[s] = o2;
            } else if (ln <= 128) {
                code_hi[s] = o1;
                code_lo[s] = (ln < 128) ? (o2 << (128 - ln)) : o2;
            }
            code_len[s] = (uint8_t)ln;
            continue;
        }
        if ((ln >> 6) == 0) {
            uint64_t n1 = o1 << 1;
            st_n[sp] = right[n]; st_l[sp] = ln + 1; st_1[sp] = n1 | 1; st_2[sp] = 0; sp++;
            st_n[sp] = left[n];  st_l[sp] = ln + 1; st_1[sp] = n1;     st_2[sp] = 0; sp++;
        } else {
            uint64_t n2 = (ln % 64 != 0) ? (o2 << 1) : o2;
            st_n[sp] = right[n]; st_l[sp] = ln + 1; st_1[sp] = o1; st_2[sp] = n2 | 1; sp++;
            st_n[sp] = left[n];  st_l[sp] = ln + 1; st_1[sp] = o1; st_2[sp] = n2; sp++;
        }
    }

    /* preorder serialization (pad_tree_*, node->left before node->right) */
    int64_t node_count = 2 * nnz - 1;
    int64_t *pn = malloc((node_count + 4) * sizeof(int64_t));
    int64_t *pp = malloc((node_count + 4) * sizeof(int64_t));
    int8_t  *pr = malloc(node_count + 4);
    int64_t psp = 0, counter = 0;
    pn[psp] = root; pp[psp] = -1; pr[psp] = 0; psp++;
    while (psp > 0) {
        psp--;
        int64_t n = pn[psp], parent = pp[psp];
        int8_t isr = pr[psp];
        int64_t idx = counter++;
        if (parent >= 0) {
            if (isr) R[parent] = (uint32_t)idx;
            else     L[parent] = (uint32_t)idx;
        }
        C[idx] = (uint32_t)sym[n];
        T[idx] = leaf[n] ? 1 : 0;
        if (!leaf[n]) {
            if (right[n] >= 0) { pn[psp] = right[n]; pp[psp] = idx; pr[psp] = 1; psp++; }
            if (left[n]  >= 0) { pn[psp] = left[n];  pp[psp] = idx; pr[psp] = 0; psp++; }
        }
    }

    free(left); free(right); free(sym); free(leaf); free(nfreq);
    free(h.slots); free(h.freqs);
    free(st_n); free(st_l); free(st_1); free(st_2);
    free(pn); free(pp); free(pr);
    return node_count;
}

/* ------------------------------------------------------------------ */
/* Exact-value escape stream (addExactData dataCompression.c:575,      */
/* updateLossyCompElement CompressElement.c:230) — batched, and its    */
/* decode (the classic 1D decoder with every type an escape).          */
/* ------------------------------------------------------------------ */

typedef struct {
    int esize, req_bytes, resi_len;
    uint8_t prev[8];
    uint8_t *lead;  int64_t nlead;
    uint8_t *mid;   int64_t nmid;
    uint8_t *resi;  int64_t nresi;
} xenc;

static inline float xenc_add_f32(xenc *E, float value, float median,
                                 int raw, uint32_t mask) {
    float norm = raw ? value : value - median;
    uint32_t ival;
    memcpy(&ival, &norm, 4);
    uint8_t cur[4] = { (uint8_t)(ival >> 24), (uint8_t)(ival >> 16),
                       (uint8_t)(ival >> 8), (uint8_t)ival };
    uint32_t rbits = ival & mask;
    float recon;
    memcpy(&recon, &rbits, 4);
    if (!raw) recon = recon + median;
    int lead = 0;
    while (lead < 3 && cur[lead] == E->prev[lead]) lead++;
    E->lead[E->nlead++] = (uint8_t)lead;
    for (int b = lead; b < E->req_bytes; b++) E->mid[E->nmid++] = cur[b];
    if (E->resi_len && E->req_bytes < 4)
        E->resi[E->nresi++] = cur[E->req_bytes] >> (8 - E->resi_len);
    memcpy(E->prev, cur, 4);
    return recon;
}

static inline double xenc_add_f64(xenc *E, double value, double median,
                                  int raw, uint64_t mask) {
    double norm = raw ? value : value - median;
    uint64_t ival;
    memcpy(&ival, &norm, 8);
    uint8_t cur[8];
    for (int b = 0; b < 8; b++) cur[b] = (uint8_t)(ival >> (56 - 8 * b));
    uint64_t rbits = ival & mask;
    double recon;
    memcpy(&recon, &rbits, 8);
    if (!raw) recon = recon + median;
    int lead = 0;
    while (lead < 3 && cur[lead] == E->prev[lead]) lead++;
    E->lead[E->nlead++] = (uint8_t)lead;
    for (int b = lead; b < E->req_bytes; b++) E->mid[E->nmid++] = cur[b];
    if (E->resi_len && E->req_bytes < 8)
        E->resi[E->nresi++] = cur[E->req_bytes] >> (8 - E->resi_len);
    memcpy(E->prev, cur, 8);
    return recon;
}

static inline uint64_t xenc_mask(int esize, int req_length) {
    int ign = esize * 8 - req_length;
    if (ign < 0) ign = 0;
    uint64_t full = esize == 4 ? 0xFFFFFFFFull : 0xFFFFFFFFFFFFFFFFull;
    return (~((1ull << ign) - 1ull)) & full;
}

/* Batched escape stream: state passed in/out so Python can interleave
 * batches with its own adds.  prev_io: 8 bytes.  Returns new lead
 * count (== entries appended so far in this call: n). */
void exact_stream_f32(const float *vals, int64_t n, int req_length,
                      float median, int raw, uint8_t *prev_io,
                      uint8_t *lead, uint8_t *mid, int64_t *nmid,
                      uint8_t *resi, float *recon) {
    xenc E;
    E.esize = 4; E.req_bytes = req_length / 8; E.resi_len = req_length % 8;
    if (E.req_bytes > 4) E.req_bytes = 4;
    memcpy(E.prev, prev_io, 8);
    E.lead = lead; E.nlead = 0;
    E.mid = mid; E.nmid = 0;
    E.resi = resi; E.nresi = 0;
    uint32_t mask = (uint32_t)xenc_mask(4, req_length);
    for (int64_t i = 0; i < n; i++) {
        float r = xenc_add_f32(&E, vals[i], median, raw, mask);
        if (recon) recon[i] = r;
    }
    memcpy(prev_io, E.prev, 8);
    *nmid = E.nmid;
}

void exact_stream_f64(const double *vals, int64_t n, int req_length,
                      double median, int raw, uint8_t *prev_io,
                      uint8_t *lead, uint8_t *mid, int64_t *nmid,
                      uint8_t *resi, double *recon) {
    xenc E;
    E.esize = 8; E.req_bytes = req_length / 8; E.resi_len = req_length % 8;
    if (E.req_bytes > 8) E.req_bytes = 8;
    memcpy(E.prev, prev_io, 8);
    E.lead = lead; E.nlead = 0;
    E.mid = mid; E.nmid = 0;
    E.resi = resi; E.nresi = 0;
    uint64_t mask = xenc_mask(8, req_length);
    for (int64_t i = 0; i < n; i++) {
        double r = xenc_add_f64(&E, vals[i], median, raw, mask);
        if (recon) recon[i] = r;
    }
    memcpy(prev_io, E.prev, 8);
    *nmid = E.nmid;
}

/* Classic 1D MDQ encode (SZ_compress_float_1D_MDQ sz_float.c:353-524):
 * previous-reconstruction predictor, the float quantizer with its
 * machine-epsilon recheck.  With subblock, SZ_compress_float_1D_MDQ_
 * subblock (sz_float.c:3444, SZ_compress_args3's kernel): a 2a - b
 * predictor, the quantizer in double on rp64, no recheck.  Returns the
 * exact-value count. */
int64_t classic1d_encode_f32(const float *x, int64_t n, float rp,
                             double rp64, int intervals, int radius,
                             int req_length, float median, int subblock,
                             int32_t *types, uint8_t *lead, uint8_t *mid,
                             int64_t *nmid, uint8_t *resi) {
    xenc E;
    E.esize = 4; E.req_bytes = req_length / 8; E.resi_len = req_length % 8;
    if (E.req_bytes > 4) E.req_bytes = 4;
    memset(E.prev, 0, 8);
    E.lead = lead; E.nlead = 0; E.mid = mid; E.nmid = 0;
    E.resi = resi; E.nresi = 0;
    uint32_t mask = (uint32_t)xenc_mask(4, req_length);
    float last1 = 0.0f, pred = 0.0f;
    for (int i = 0; i < 2 && i < n; i++) {
        float rec = xenc_add_f32(&E, x[i], median, 0, mask);
        types[i] = 0;
        last1 = pred;
        pred = rec;
    }
    float check_radius = (float)(intervals - 1) * rp;
    float interval2 = 2.0f * rp;
    float recip = 1.0f / rp;
    if (subblock) {
        double check64 = (intervals - 1) * rp64;
        double interval64 = 2.0 * rp64;
        float last0 = pred;
        for (int64_t i = 2; i < n; i++) {
            float cur = x[i];
            float p = 2.0f * last0 - last1;
            float pae = fabsf(cur - p);
            if ((double)pae <= check64) {
                int state = (int)(((double)pae / rp64 + 1.0) / 2.0);
                if (cur >= p) {
                    types[i] = radius + state;
                    p = (float)((double)p + state * interval64);
                } else {
                    types[i] = radius - state;
                    p = (float)((double)p - state * interval64);
                }
                last1 = last0; last0 = p;
            } else {
                types[i] = 0;
                last1 = last0;
                last0 = xenc_add_f32(&E, cur, median, 0, mask);
            }
        }
    } else {
        for (int64_t i = 2; i < n; i++) {
            float cur = x[i];
            float err = fabsf(cur - pred);
            if (err < check_radius) {
                int state = ((int)(err * recip + 1.0f)) >> 1;
                if (cur >= pred) {
                    types[i] = radius + state;
                    pred = pred + (float)state * interval2;
                } else {
                    types[i] = radius - state;
                    pred = pred - (float)state * interval2;
                }
                if (fabsf(cur - pred) > rp) {
                    types[i] = 0;
                    pred = xenc_add_f32(&E, cur, median, 0, mask);
                }
            } else {
                types[i] = 0;
                pred = xenc_add_f32(&E, cur, median, 0, mask);
            }
        }
    }
    *nmid = E.nmid;
    return E.nlead;
}

/* The double twin (SZ_compress_double_1D_MDQ sz_double.c:260-395):
 * state = (int)((err*recip + 1) * 0.5), no epsilon recheck. */
int64_t classic1d_encode_f64(const double *x, int64_t n, double rp,
                             double rp64, int intervals, int radius,
                             int req_length, double median, int subblock,
                             int32_t *types, uint8_t *lead, uint8_t *mid,
                             int64_t *nmid, uint8_t *resi) {
    xenc E;
    E.esize = 8; E.req_bytes = req_length / 8; E.resi_len = req_length % 8;
    if (E.req_bytes > 8) E.req_bytes = 8;
    memset(E.prev, 0, 8);
    E.lead = lead; E.nlead = 0; E.mid = mid; E.nmid = 0;
    E.resi = resi; E.nresi = 0;
    uint64_t mask = xenc_mask(8, req_length);
    double last1 = 0.0, pred = 0.0;
    for (int i = 0; i < 2 && i < n; i++) {
        double rec = xenc_add_f64(&E, x[i], median, 0, mask);
        types[i] = 0;
        last1 = pred;
        pred = rec;
    }
    double check_radius = (double)(intervals - 1) * rp;
    double interval2 = 2.0 * rp;
    double recip = 1.0 / rp;
    if (subblock) {
        double check64 = (intervals - 1) * rp64;
        double interval64 = 2.0 * rp64;
        double last0 = pred;
        for (int64_t i = 2; i < n; i++) {
            double cur = x[i];
            double p = 2.0 * last0 - last1;
            double pae = fabs(cur - p);
            if (pae <= check64) {
                int state = (int)((pae / rp64 + 1.0) / 2.0);
                if (cur >= p) {
                    types[i] = radius + state;
                    p = p + state * interval64;
                } else {
                    types[i] = radius - state;
                    p = p - state * interval64;
                }
                last1 = last0; last0 = p;
            } else {
                types[i] = 0;
                last1 = last0;
                last0 = xenc_add_f64(&E, cur, median, 0, mask);
            }
        }
    } else {
        for (int64_t i = 2; i < n; i++) {
            double cur = x[i];
            double err = fabs(cur - pred);
            if (err < check_radius) {
                int state = (int)((err * recip + 1.0) * 0.5);
                if (cur >= pred) {
                    types[i] = radius + state;
                    pred = pred + (double)state * interval2;
                } else {
                    types[i] = radius - state;
                    pred = pred - (double)state * interval2;
                }
            } else {
                types[i] = 0;
                pred = xenc_add_f64(&E, cur, median, 0, mask);
            }
        }
    }
    *nmid = E.nmid;
    return E.nlead;
}

/* The escape stream's decoder (one value a call), shared by the 1-D
 * decoders below. */
typedef struct {
    int esize, req_bytes, resi_len;
    uint8_t prev[8];
    const uint8_t *lead;  int64_t k;
    const uint8_t *mid;   int64_t midp;
    const uint8_t *resi;  int64_t bitp;
} xdec;

static inline void xdec_init(xdec *D, int esize, int req_length,
                             const uint8_t *lead, const uint8_t *mid,
                             const uint8_t *resi) {
    D->esize = esize;
    D->req_bytes = req_length / 8;
    D->resi_len = req_length % 8;
    if (D->req_bytes > esize) D->req_bytes = esize;
    memset(D->prev, 0, 8);
    D->lead = lead; D->k = 0; D->mid = mid; D->midp = 0;
    D->resi = resi; D->bitp = 0;
}

/* The next value's big-endian bytes, into D->prev. */
static inline void xdec_bytes(xdec *D) {
    uint8_t b[8] = {0};
    int ln = D->lead[D->k++];
    for (int j = 0; j < ln; j++) b[j] = D->prev[j];
    for (int j = ln; j < D->req_bytes; j++) b[j] = D->mid[D->midp++];
    if (D->resi_len && D->req_bytes < D->esize) {
        int v = 0;
        for (int w = 0; w < D->resi_len; w++) {
            v = (v << 1)
              | ((D->resi[D->bitp >> 3] >> (7 - (D->bitp & 7))) & 1);
            D->bitp++;
        }
        b[D->req_bytes] = (uint8_t)(v << (8 - D->resi_len));
    }
    memcpy(D->prev, b, D->esize);
}

static inline float xdec_next_f32(xdec *D, float median, int raw) {
    xdec_bytes(D);
    const uint8_t *b = D->prev;
    uint32_t ival = ((uint32_t)b[0] << 24) | ((uint32_t)b[1] << 16)
                  | ((uint32_t)b[2] << 8) | b[3];
    float val;
    memcpy(&val, &ival, 4);
    return raw ? val : val + median;
}

static inline double xdec_next_f64(xdec *D, double median, int raw) {
    xdec_bytes(D);
    uint64_t ival = 0;
    for (int j = 0; j < 8; j++) ival = (ival << 8) | D->prev[j];
    double val;
    memcpy(&val, &ival, 8);
    return raw ? val : val + median;
}

/* Classic 1D decode (decompressDataSeries_float_1D szd_float.c:185).
 * lead: unpacked 2-bit values; resi consumed as a bit cursor. */
void classic1d_decode_f32(const int32_t *types, int64_t n, float interval2,
                          int radius, int req_length, float median, int raw,
                          const uint8_t *lead, const uint8_t *mid,
                          const uint8_t *resi, float *out) {
    xdec D;
    xdec_init(&D, 4, req_length, lead, mid, resi);
    float cur = 0.0f;
    for (int64_t i = 0; i < n; i++) {
        int t = types[i];
        if (t == 0)
            cur = xdec_next_f32(&D, median, raw);
        else
            cur = cur + (float)(t - radius) * interval2;
        out[i] = cur;
    }
}

void classic1d_decode_f64(const int32_t *types, int64_t n, double interval2,
                          int radius, int req_length, double median, int raw,
                          const uint8_t *lead, const uint8_t *mid,
                          const uint8_t *resi, double *out) {
    xdec D;
    xdec_init(&D, 8, req_length, lead, mid, resi);
    double cur = 0.0;
    for (int64_t i = 0; i < n; i++) {
        int t = types[i];
        if (t == 0)
            cur = xdec_next_f64(&D, median, raw);
        else
            cur = cur + (double)(t - radius) * interval2;
        out[i] = cur;
    }
}

/* The MSST19 cache-table lookup of a prediction ratio: 0 outside. */
static inline int msst19_lookup(double ratio, const uint16_t *table,
                                int64_t base_index, int64_t top_index,
                                int bits, int64_t row_size) {
    uint64_t b;
    memcpy(&b, &ratio, 8);
    int64_t expo = (int64_t)((b & 0x7FFFFFFFFFFFFFFFull) >> 52)
                   - base_index;
    if (expo < 0 || expo > top_index - base_index) return 0;
    uint64_t manti = (b & 0x000FFFFFFFFFFFFFull) >> (52 - bits);
    return table[expo * row_size + manti];
}

/* 1-D MSST19 encode (SZ_compress_float_1D_MDQ_MSST19): the first two
 * values escape, then the state of cur/pred multiplies the previous
 * reconstruction (no fabs in 1-D).  Returns the escape count. */
int64_t msst19_encode1d_f32(const float *x, int64_t n,
                            const uint16_t *table, int64_t base_index,
                            int64_t top_index, int bits, int64_t row_size,
                            const double *ptable, int req_length,
                            int32_t *types, uint8_t *lead, uint8_t *mid,
                            int64_t *nmid, uint8_t *resi) {
    xenc E;
    E.esize = 4; E.req_bytes = req_length / 8; E.resi_len = req_length % 8;
    if (E.req_bytes > 4) E.req_bytes = 4;
    memset(E.prev, 0, 8);
    E.lead = lead; E.nlead = 0; E.mid = mid; E.nmid = 0;
    E.resi = resi; E.nresi = 0;
    uint32_t mask = (uint32_t)xenc_mask(4, req_length);
    float pred = 0.0f;
    for (int i = 0; i < 2 && i < n; i++) {
        types[i] = 0;
        pred = xenc_add_f32(&E, x[i], 0.0f, 1, mask);
    }
    for (int64_t i = 2; i < n; i++) {
        float cur = x[i];
        float ratio = cur / pred;
        int st = msst19_lookup((double)ratio, table, base_index,
                               top_index, bits, row_size);
        if (st) {
            types[i] = st;
            pred = (float)((double)pred * ptable[st]);
        } else {
            types[i] = 0;
            pred = xenc_add_f32(&E, cur, 0.0f, 1, mask);
        }
    }
    *nmid = E.nmid;
    return E.nlead;
}

/* 1-D MSST19 decode (decompressDataSeries_float_1D_MSST19): a state
 * multiplies |previous value| by its precision factor. */
void msst19_decode1d_f32(const int32_t *types, int64_t n,
                         const double *ptable, int req_length,
                         const uint8_t *lead, const uint8_t *mid,
                         const uint8_t *resi, float *out) {
    xdec D;
    xdec_init(&D, 4, req_length, lead, mid, resi);
    float prev = 0.0f;
    for (int64_t i = 0; i < n; i++) {
        int t = types[i];
        prev = t ? (float)(fabs((double)prev) * ptable[t])
                 : xdec_next_f32(&D, 0.0f, 1);
        out[i] = prev;
    }
}

/* glibc log2/exp2, one element at a time (the pre-log PW_REL transform:
 * sz_float_pwr.c:1810, szd_float_pwr.c:1340). */
void v_log2_f64(const double *x, double *out, int64_t n) {
    for (int64_t i = 0; i < n; i++) out[i] = log2(x[i]);
}

void v_exp2_f64(const double *x, double *out, int64_t n) {
    for (int64_t i = 0; i < n; i++) out[i] = exp2(x[i]);
}

/* One-pass MSST19 range/sign scan (computeRangeSize_*_MSST19).
 * signs[0] stays 0; near starts at x[0], strictly-smaller nonzero
 * magnitudes update it (first occurrence wins).  Returns positive. */
int range_scan_f32(const float *x, int64_t n, uint8_t *signs,
                   float *fmin, float *fmax, float *near) {
    int positive = 1;
    float mn = x[0], mx = x[0], nr = x[0];
    signs[0] = 0;
    for (int64_t i = 1; i < n; i++) {
        float v = x[i];
        int s = v < 0;
        signs[i] = (uint8_t)s;
        if (s) positive = 0;
        if (v < mn) mn = v;
        if (v > mx) mx = v;
        if (v != 0 && fabsf(v) < fabsf(nr)) nr = v;
    }
    *fmin = mn; *fmax = mx; *near = nr;
    return positive;
}

/* MSST19 cache-table construction
 * (MultiLevelCacheTableWideInterval.c:47-186 state machine): for each
 * (exponent subrange, truncated mantissa) cell, assign the precision-
 * table interval whose (lo, hi) window contains the cell. */
void msst19_build_table(const double *pt, int64_t count, double precision,
                        int bits, int64_t base_index, int64_t nsub,
                        uint16_t *table) {
    int64_t size = 1ll << bits;
    double *lo = malloc(count * sizeof(double));
    double *hi = malloc(count * sizeof(double));
    for (int64_t i = 0; i < count; i++) {
        lo[i] = pt[i] / (1 + precision);
        hi[i] = pt[i] / (1 - precision);
    }
    int64_t index = 0;
    int flag = 0;
    for (int64_t i = 0; i < nsub; i++) {
        int64_t expo = i + base_index;
        for (int64_t j = 0; j < size; j++) {
            uint64_t vb = ((uint64_t)expo << 52)
                        + ((uint64_t)j << (52 - bits));
            uint64_t vt = ((uint64_t)expo << 52)
                        + ((uint64_t)(j + 1) << (52 - bits));
            double bot_s, top_s;
            memcpy(&bot_s, &vb, 8);
            memcpy(&top_s, &vt, 8);
            if (top_s < hi[index] && bot_s > lo[index]) {
                table[i * size + j] = (uint16_t)index;
                flag = 1;
            } else if (flag && index < count - 1) {
                index++;
                table[i * size + j] = (uint16_t)index;
            } else {
                table[i * size + j] = 0;
            }
        }
    }
    free(lo); free(hi);
}

/* MSB-first fixed-width (w < 8) bit pack of byte values
 * (convertIntArray2ByteArray_fast_dynamic, TypeManager.c:377). */
void pack_w_bits(const uint8_t *vals, int64_t n, int w, uint8_t *out) {
    uint64_t acc = 0;
    int accbits = 0;
    int64_t ob = 0;
    for (int64_t i = 0; i < n; i++) {
        acc = (acc << w) | vals[i];
        accbits += w;
        while (accbits >= 8) {
            out[ob++] = (uint8_t)(acc >> (accbits - 8));
            accbits -= 8;
        }
    }
    if (accbits) out[ob++] = (uint8_t)(acc << (8 - accbits));
}

/* ------------------------------------------------------------------ */
/* float64 data: the range/sign scan and the 1-D MSST19 codec          */
/* ------------------------------------------------------------------ */

int range_scan_f64(const double *x, int64_t n, uint8_t *signs,
                   double *fmin, double *fmax, double *near) {
    int positive = 1;
    double mn = x[0], mx = x[0], nr = x[0];
    signs[0] = 0;
    for (int64_t i = 1; i < n; i++) {
        double v = x[i];
        int s = v < 0;
        signs[i] = (uint8_t)s;
        if (s) positive = 0;
        if (v < mn) mn = v;
        if (v > mx) mx = v;
        if (v != 0 && fabs(v) < fabs(nr)) nr = v;
    }
    *fmin = mn; *fmax = mx; *near = nr;
    return positive;
}

/* 1-D MSST19 encode of double data: the float form's chain in double
 * (no rounding of the prediction).  Returns the escape count. */
int64_t msst19_encode1d_f64(const double *x, int64_t n,
                            const uint16_t *table, int64_t base_index,
                            int64_t top_index, int bits, int64_t row_size,
                            const double *ptable, int req_length,
                            int32_t *types, uint8_t *lead, uint8_t *mid,
                            int64_t *nmid, uint8_t *resi) {
    xenc E;
    E.esize = 8; E.req_bytes = req_length / 8; E.resi_len = req_length % 8;
    if (E.req_bytes > 8) E.req_bytes = 8;
    memset(E.prev, 0, 8);
    E.lead = lead; E.nlead = 0; E.mid = mid; E.nmid = 0;
    E.resi = resi; E.nresi = 0;
    uint64_t mask = xenc_mask(8, req_length);
    double pred = 0.0;
    for (int i = 0; i < 2 && i < n; i++) {
        types[i] = 0;
        pred = xenc_add_f64(&E, x[i], 0.0, 1, mask);
    }
    for (int64_t i = 2; i < n; i++) {
        double cur = x[i];
        int st = msst19_lookup(cur / pred, table, base_index, top_index,
                               bits, row_size);
        if (st) {
            types[i] = st;
            pred = pred * ptable[st];
        } else {
            types[i] = 0;
            pred = xenc_add_f64(&E, cur, 0.0, 1, mask);
        }
    }
    *nmid = E.nmid;
    return E.nlead;
}

/* 1-D MSST19 decode of double data. */
void msst19_decode1d_f64(const int32_t *types, int64_t n,
                         const double *ptable, int req_length,
                         const uint8_t *lead, const uint8_t *mid,
                         const uint8_t *resi, double *out) {
    xdec D;
    xdec_init(&D, 8, req_length, lead, mid, resi);
    double prev = 0.0;
    for (int64_t i = 0; i < n; i++) {
        int t = types[i];
        prev = t ? fabs(prev) * ptable[t] : xdec_next_f64(&D, 0.0, 1);
        out[i] = prev;
    }
}

/* ------------------------------------------------------------------ */
/* The random-access codec's coefficient chain (sz_float.c:9677-9712): */
/* double division with float last values, distinct from the           */
/* regression codec's float chain above.                               */
/* ------------------------------------------------------------------ */

void ra_coeff_chain_f32(const float *coeffs, int64_t nreg, int nc,
                        const double *prec, int cap, int radius,
                        int32_t *ctypes, float *unpred, int64_t *ucnt,
                        float *qcoeffs) {
    float last[8] = {0};
    for (int e = 0; e < nc; e++) ucnt[e] = 0;
    for (int64_t n = 0; n < nreg; n++) {
        for (int e = 0; e < nc; e++) {
            float cur = coeffs[n * nc + e];
            double diff = (double)(cur - last[e]);
            double itv = fabs(diff) / prec[e] + 1.0;
            if (itv < (double)cap) {
                if (diff < 0) itv = -itv;
                int t = (int)(itv / 2) + radius;
                float rec = (float)((double)last[e]
                                    + (double)(2 * (t - radius)) * prec[e]);
                if (fabs((double)(cur - rec)) > prec[e]) {
                    ctypes[e * nreg + n] = 0;
                    last[e] = cur;
                    unpred[e * nreg + ucnt[e]++] = cur;
                } else {
                    ctypes[e * nreg + n] = t;
                    last[e] = rec;
                }
            } else {
                ctypes[e * nreg + n] = 0;
                last[e] = cur;
                unpred[e * nreg + ucnt[e]++] = cur;
            }
            qcoeffs[n * nc + e] = last[e];
        }
    }
}

void ra_coeff_chain_decode_f32(const int32_t *ctypes, int64_t nreg, int nc,
                               const double *prec, const int32_t *radius,
                               const float *unpred_flat, const int64_t *off,
                               float *qcoeffs) {
    float last[8] = {0};
    int64_t cur[8];
    for (int e = 0; e < nc; e++) cur[e] = off[e];
    for (int64_t n = 0; n < nreg; n++) {
        for (int e = 0; e < nc; e++) {
            int32_t t = ctypes[e * nreg + n];
            if (t != 0)
                last[e] = (float)((double)last[e]
                                  + (double)(2 * (t - radius[e])) * prec[e]);
            else
                last[e] = unpred_flat[cur[e]++];
            qcoeffs[n * nc + e] = last[e];
        }
    }
}

/* ------------------------------------------------------------------ */
/* Per-block Huffman streams with one shared table (the random-access  */
/* format): each block's bitstream MSB-first, padded to a byte, and    */
/* its decode by a walk of the serialized tree.                        */
/* ------------------------------------------------------------------ */

static inline int64_t put_bits(uint64_t word, int len, uint64_t *acc,
                               int *accbits, uint8_t *out, int64_t ob) {
    int room = 64 - *accbits;
    int placed = len < room ? len : room;
    *acc |= word >> *accbits;
    *accbits += placed;
    while (*accbits >= 8) {
        out[ob++] = (uint8_t)(*acc >> 56);
        *acc <<= 8;
        *accbits -= 8;
    }
    int rem = len - placed;
    if (rem > 0) {
        *acc |= (word << placed) >> *accbits;
        *accbits += rem;
        while (*accbits >= 8) {
            out[ob++] = (uint8_t)(*acc >> 56);
            *acc <<= 8;
            *accbits -= 8;
        }
    }
    return ob;
}

static int64_t huff_encode(const int32_t *syms, int64_t n,
                           const uint64_t *code_hi, const uint64_t *code_lo,
                           const uint8_t *code_len, uint8_t *out) {
    uint64_t acc = 0;
    int accbits = 0;
    int64_t ob = 0;
    for (int64_t i = 0; i < n; i++) {
        int32_t s = syms[i];
        int len = code_len[s];
        if (len <= 64) {
            ob = put_bits(code_hi[s], len, &acc, &accbits, out, ob);
        } else {
            ob = put_bits(code_hi[s], 64, &acc, &accbits, out, ob);
            ob = put_bits(code_lo[s], len - 64, &acc, &accbits, out, ob);
        }
    }
    if (accbits > 0) out[ob++] = (uint8_t)(acc >> 56);
    return ob;
}

/* Per-block byte sizes; returns the total byte count. */
int64_t huff_block_sizes(const int32_t *syms, int64_t nb, int64_t ncell,
                         const uint8_t *code_len, uint32_t *sizes) {
    int64_t total = 0;
    for (int64_t b = 0; b < nb; b++) {
        const int32_t *s = syms + b * ncell;
        int64_t bits = 0;
        for (int64_t i = 0; i < ncell; i++) bits += code_len[s[i]];
        sizes[b] = (uint32_t)((bits + 7) / 8);
        total += sizes[b];
    }
    return total;
}

/* Encode all blocks into `out` (sized by huff_block_sizes). */
void huff_encode_blocks(const int32_t *syms, int64_t nb, int64_t ncell,
                        const uint64_t *code_hi, const uint64_t *code_lo,
                        const uint8_t *code_len, const uint32_t *sizes,
                        uint8_t *out) {
    int64_t off = 0;
    for (int64_t b = 0; b < nb; b++) {
        huff_encode(syms + b * ncell, ncell, code_hi, code_lo, code_len,
                    out + off);
        off += sizes[b];
    }
}

/* Bit walk over the preorder tree (decode, Huffman.c:310-343). */
static int64_t huff_tree_decode(const int32_t *L, const int32_t *R,
                                const int32_t *C, const uint8_t *T,
                                const uint8_t *data, int64_t nbytes,
                                int32_t *out, int64_t count) {
    int64_t k = 0;
    int32_t n = 0;
    for (int64_t i = 0; i < nbytes && k < count; i++) {
        uint8_t byte = data[i];
        for (int bit = 7; bit >= 0; bit--) {
            n = (byte >> bit) & 1 ? R[n] : L[n];
            if (T[n]) {
                out[k++] = C[n];
                if (k >= count) break;
                n = 0;
            }
        }
    }
    return k;
}

/* nsel per-block bitstreams of `count` symbols: block b's at
 * data + offsets[b], sizes[b] bytes. */
void huff_tree_decode_blocks(const int32_t *L, const int32_t *R,
                             const int32_t *C, const uint8_t *T,
                             const uint8_t *data, const int64_t *offsets,
                             const int64_t *sizes, int64_t nsel,
                             int64_t count, int32_t *out) {
    for (int64_t b = 0; b < nsel; b++)
        huff_tree_decode(L, R, C, T, data + offsets[b], sizes[b],
                         out + b * count, count);
}

/* ------------------------------------------------------------------ */
/* The 1-D integer codec (SZ_compress_intXX_1D_MDQ, e.g. sz_int32.c:   */
/* 228; decompressDataSeries_intXX_1D): the previous-value chain in    */
/* the width a1_bits, escapes stored as big-endian (value - min) in    */
/* byte_size bytes.  The first two values always escape.               */
/* ------------------------------------------------------------------ */

static inline int64_t wrap_bits(int64_t v, int bits, int sgn) {
    if (bits >= 64) return v;
    uint64_t m = (~0ull) >> (64 - bits);
    uint64_t u = (uint64_t)v & m;
    if (sgn && (u >> (bits - 1))) return (int64_t)(u | ~m);
    return (int64_t)u;
}

static inline int64_t ld_int(const uint8_t *p, int esize, int sgn) {
    switch (esize) {
        case 1: return sgn ? (int64_t)*(const int8_t *)p
                           : (int64_t)*(const uint8_t *)p;
        case 2: return sgn ? (int64_t)*(const int16_t *)p
                           : (int64_t)*(const uint16_t *)p;
        case 4: return sgn ? (int64_t)*(const int32_t *)p
                           : (int64_t)*(const uint32_t *)p;
        default: return *(const int64_t *)p;
    }
}

static inline void int_store(uint8_t *exact, int64_t *ecnt, int64_t value,
                             int64_t min_value, int byte_size,
                             int store_esize) {
    uint64_t m = (store_esize >= 8) ? ~0ull
                 : ((~0ull) >> (64 - 8 * store_esize));
    uint64_t d = ((uint64_t)(value - min_value)) & m;
    for (int b = 0; b < byte_size; b++)
        exact[*ecnt * byte_size + b] =
            (uint8_t)(d >> (8 * (byte_size - 1 - b)));
    (*ecnt)++;
}

/* Returns the escape count. */
int64_t int1d_encode(const uint8_t *x, int in_esize, int in_sgn,
                     int64_t n, double rp, int intervals, int radius,
                     int a1_bits, int a1_sgn, int64_t min_value,
                     int byte_size, int store_esize, int32_t *types,
                     uint8_t *exact) {
    int64_t ecnt = 0;
    double check_radius = (intervals - 1) * rp;
    double interval2 = 2.0 * rp;
    types[0] = 0;
    int_store(exact, &ecnt, ld_int(x, in_esize, in_sgn), min_value,
              byte_size, store_esize);
    if (n < 2) return ecnt;
    types[1] = 0;
    int64_t v1 = ld_int(x + in_esize, in_esize, in_sgn);
    int_store(exact, &ecnt, v1, min_value, byte_size, store_esize);
    int64_t pred = wrap_bits(v1, a1_bits, a1_sgn);
    for (int64_t i = 2; i < n; i++) {
        int64_t cur = ld_int(x + i * in_esize, in_esize, in_sgn);
        int64_t d = cur - pred;
        int64_t pae = wrap_bits(d < 0 ? -d : d, a1_bits, a1_sgn);
        if ((double)pae < check_radius) {
            int state = (int)(((double)pae / rp + 1.0) / 2.0);
            if (cur >= pred) {
                types[i] = radius + state;
                pred = wrap_bits((int64_t)trunc((double)pred
                                                + state * interval2),
                                 a1_bits, a1_sgn);
            } else {
                types[i] = radius - state;
                pred = wrap_bits((int64_t)trunc((double)pred
                                                - state * interval2),
                                 a1_bits, a1_sgn);
            }
        } else {
            types[i] = 0;
            int_store(exact, &ecnt, cur, min_value, byte_size, store_esize);
            pred = wrap_bits(cur, a1_bits, a1_sgn);
        }
    }
    return ecnt;
}

void int1d_decode(const int32_t *types, int64_t n, double interval2,
                  int radius, int t_bits, int t_sgn, int64_t min_value,
                  int byte_size, int store_esize, const uint8_t *exact,
                  int64_t *out) {
    int64_t epos = 0;
    uint64_t mask = (store_esize >= 8) ? ~0ull
                    : ((~0ull) >> (64 - 8 * store_esize));
    int64_t prev = 0;
    for (int64_t i = 0; i < n; i++) {
        int t = types[i];
        if (t == 0) {
            uint64_t v = 0;
            for (int b = 0; b < byte_size; b++)
                v = (v << 8) | exact[epos++];
            v = (v + (uint64_t)min_value) & mask;
            prev = wrap_bits((int64_t)v, t_bits, t_sgn);
        } else {
            prev = wrap_bits(
                (int64_t)trunc((double)prev + (t - radius) * interval2),
                t_bits, t_sgn);
        }
        out[i] = prev;
    }
}

/* The sz_omp format's block codec (SZ_compress_float_3D_MDQ_RA_block,
 * sz_float.c:4704, and its double twin sz_double.c:4396; their decode
 * decompressDataSeries_*_3D_RA_block): the classic positional scheme on
 * one block, its first value predicted from itself (the mean seed),
 * escapes stored raw.  Returns the escape count. */
#define GEN_OMPB(SUF, FT)                                               \
static inline FT ompb_quant_##SUF(int32_t *types, int64_t idx, FT cur,  \
                                  FT pred, double rp64, double recip64, \
                                  FT rp, int intervals, int radius,     \
                                  int dbl, FT *unpred, int64_t *ucnt) { \
    FT diff = cur - pred;                                               \
    if (dbl) {                                                          \
        double itv = fabs((double)diff) * recip64 + 1.0;                \
        if (itv < (double)intervals) {                                  \
            if (diff < 0) itv = -itv;                                   \
            int t = (int)(itv / 2.0) + radius;                          \
            FT rec = (FT)((double)pred                                  \
                          + (double)(2 * (t - radius)) * rp64);         \
            if (!(fabs((double)(FT)(cur - rec)) > rp64)) {              \
                types[idx] = t;                                         \
                return rec;                                             \
            }                                                           \
        }                                                               \
    } else {                                                            \
        FT itv = (FT)(fabs((double)diff) * recip64 + 1.0);              \
        if (itv < (FT)intervals) {                                      \
            if (diff < 0) itv = -itv;                                   \
            int t = (int)(itv / (FT)2) + radius;                        \
            FT rec = pred + (FT)(2 * (t - radius)) * rp;                \
            if (!(fabs((double)(FT)(cur - rec)) > rp64)) {              \
                types[idx] = t;                                         \
                return rec;                                             \
            }                                                           \
        }                                                               \
    }                                                                   \
    types[idx] = 0;                                                     \
    unpred[(*ucnt)++] = cur;                                            \
    return cur;                                                         \
}                                                                       \
                                                                        \
int64_t ompblock_encode_##SUF(const FT *x, int64_t r1, int64_t r2,      \
                              int64_t r3, double rp64, double recip64,  \
                              FT rp, int intervals, int radius,         \
                              int dbl, int32_t *types, FT *unpred) {    \
    int64_t r23 = r2 * r3;                                              \
    FT *P1 = malloc(r23 * sizeof(FT));                                  \
    FT *P0 = malloc(r23 * sizeof(FT));                                  \
    int64_t ucnt = 0;                                                   \
    P1[0] = ompb_quant_##SUF(types, 0, x[0], x[0], rp64, recip64, rp,   \
                             intervals, radius, dbl, unpred, &ucnt);    \
    if (r3 > 1)                                                         \
        P1[1] = ompb_quant_##SUF(types, 1, x[1], P1[0], rp64, recip64,  \
                                 rp, intervals, radius, dbl, unpred,    \
                                 &ucnt);                                \
    for (int64_t j = 2; j < r3; j++) {                                  \
        FT pred = (FT)2 * P1[j-1] - P1[j-2];                            \
        P1[j] = ompb_quant_##SUF(types, j, x[j], pred, rp64, recip64,   \
                                 rp, intervals, radius, dbl, unpred,    \
                                 &ucnt);                                \
    }                                                                   \
    for (int64_t i = 1; i < r2; i++) {                                  \
        int64_t ix = i * r3;                                            \
        P1[ix] = ompb_quant_##SUF(types, ix, x[ix], P1[ix - r3], rp64,  \
                                  recip64, rp, intervals, radius, dbl,  \
                                  unpred, &ucnt);                       \
        for (int64_t j = 1; j < r3; j++) {                              \
            int64_t c = ix + j;                                         \
            FT pred = P1[c-1] + P1[c-r3] - P1[c-r3-1];                  \
            P1[c] = ompb_quant_##SUF(types, c, x[c], pred, rp64,        \
                                     recip64, rp, intervals, radius,    \
                                     dbl, unpred, &ucnt);               \
        }                                                               \
    }                                                                   \
    for (int64_t k = 1; k < r1; k++) {                                  \
        int64_t index = k * r23;                                        \
        P0[0] = ompb_quant_##SUF(types, index, x[index], P1[0], rp64,   \
                                 recip64, rp, intervals, radius, dbl,   \
                                 unpred, &ucnt);                        \
        for (int64_t j = 1; j < r3; j++) {                              \
            index++;                                                    \
            FT pred = P0[j-1] + P1[j] - P1[j-1];                        \
            P0[j] = ompb_quant_##SUF(types, index, x[index], pred,      \
                                     rp64, recip64, rp, intervals,      \
                                     radius, dbl, unpred, &ucnt);       \
        }                                                               \
        for (int64_t i = 1; i < r2; i++) {                              \
            index = k * r23 + i * r3;                                   \
            int64_t i2 = i * r3;                                        \
            FT pred = P0[i2-r3] + P1[i2] - P1[i2-r3];                   \
            P0[i2] = ompb_quant_##SUF(types, index, x[index], pred,     \
                                      rp64, recip64, rp, intervals,     \
                                      radius, dbl, unpred, &ucnt);      \
            for (int64_t j = 1; j < r3; j++) {                          \
                index++;                                                \
                i2 = i * r3 + j;                                        \
                FT pred2 = P0[i2-1] + P0[i2-r3];                        \
                pred2 = pred2 + P1[i2];                                 \
                pred2 = pred2 - P0[i2-r3-1];                            \
                pred2 = pred2 - P1[i2-r3];                              \
                pred2 = pred2 - P1[i2-1];                               \
                pred2 = pred2 + P1[i2-r3-1];                            \
                P0[i2] = ompb_quant_##SUF(types, index, x[index],       \
                                          pred2, rp64, recip64, rp,     \
                                          intervals, radius, dbl,       \
                                          unpred, &ucnt);               \
            }                                                           \
        }                                                               \
        FT *t_ = P1; P1 = P0; P0 = t_;                                  \
    }                                                                   \
    free(P1); free(P0);                                                 \
    return ucnt;                                                        \
}                                                                       \
                                                                        \
static inline void ompb_rec_##SUF(const int32_t *ty, FT *o,             \
                                  int64_t idx, FT pred, double rp64,    \
                                  FT rp, int radius, int dbl,           \
                                  const FT *unpred, int64_t *up) {      \
    int t = ty[idx];                                                    \
    if (t == 0) { o[idx] = unpred[(*up)++]; return; }                   \
    if (dbl)                                                            \
        o[idx] = (FT)((double)pred                                      \
                      + (double)(2 * (t - radius)) * rp64);             \
    else                                                                \
        o[idx] = pred + (FT)(2 * (t - radius)) * rp;                    \
}                                                                       \
                                                                        \
void ompblock_decode_##SUF(const int32_t *ty, int64_t r1, int64_t r2,   \
                           int64_t r3, FT mean, double rp64, FT rp,     \
                           int radius, int dbl, const FT *unpred,       \
                           FT *o) {                                     \
    int64_t r23 = r2 * r3;                                              \
    int64_t up = 0;                                                     \
    ompb_rec_##SUF(ty, o, 0, mean, rp64, rp, radius, dbl, unpred, &up); \
    if (r3 > 1)                                                         \
        ompb_rec_##SUF(ty, o, 1, o[0], rp64, rp, radius, dbl, unpred,   \
                       &up);                                            \
    for (int64_t j = 2; j < r3; j++)                                    \
        ompb_rec_##SUF(ty, o, j, (FT)2 * o[j-1] - o[j-2], rp64, rp,     \
                       radius, dbl, unpred, &up);                       \
    for (int64_t i = 1; i < r2; i++) {                                  \
        int64_t ix = i * r3;                                            \
        ompb_rec_##SUF(ty, o, ix, o[ix - r3], rp64, rp, radius, dbl,    \
                       unpred, &up);                                    \
        for (int64_t j = 1; j < r3; j++) {                              \
            int64_t c = ix + j;                                         \
            ompb_rec_##SUF(ty, o, c, o[c-1] + o[c-r3] - o[c-r3-1],      \
                           rp64, rp, radius, dbl, unpred, &up);         \
        }                                                               \
    }                                                                   \
    for (int64_t k = 1; k < r1; k++) {                                  \
        int64_t index = k * r23;                                        \
        ompb_rec_##SUF(ty, o, index, o[index - r23], rp64, rp, radius,  \
                       dbl, unpred, &up);                               \
        for (int64_t j = 1; j < r3; j++) {                              \
            int64_t c = index + j;                                      \
            ompb_rec_##SUF(ty, o, c, o[c-1] + o[c-r23] - o[c-r23-1],    \
                           rp64, rp, radius, dbl, unpred, &up);         \
        }                                                               \
        for (int64_t i = 1; i < r2; i++) {                              \
            int64_t c = index + i * r3;                                 \
            ompb_rec_##SUF(ty, o, c,                                    \
                           o[c-r3] + o[c-r23] - o[c-r23-r3], rp64, rp,  \
                           radius, dbl, unpred, &up);                   \
            for (int64_t j = 1; j < r3; j++) {                          \
                int64_t cj = c + j;                                     \
                FT pred = o[cj-1] + o[cj-r3];                           \
                pred = pred + o[cj-r23];                                \
                pred = pred - o[cj-r3-1];                               \
                pred = pred - o[cj-r23-r3];                             \
                pred = pred - o[cj-r23-1];                              \
                pred = pred + o[cj-r23-r3-1];                           \
                ompb_rec_##SUF(ty, o, cj, pred, rp64, rp, radius, dbl,  \
                               unpred, &up);                            \
            }                                                           \
        }                                                               \
    }                                                                   \
}

GEN_OMPB(f32, float)
GEN_OMPB(f64, double)
#undef GEN_OMPB
