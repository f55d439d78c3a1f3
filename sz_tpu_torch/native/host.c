/* Host runtime of sz_tpu_torch: the strictly serial host stages of the
 * regression codec, in C where Python would dominate the wall clock.
 * Copied from sz_tpu/native/core.c (same arithmetic, same order):
 *   - ordered float accumulation (C `acc += x`; sz_float.c:6658-6669)
 *   - the coefficient delta-quantization chain and its decode
 *     (sz_float.c:6787-6814, szd_float.c:3376-3414)
 *   - the reference-exact Huffman tree build (Huffman.c:76-185, 443-585)
 *
 * Built with `cc -O3 -ffp-contract=off` (no FMA contraction, no
 * -march, no fast-math) by sz_tpu_torch/native/__init__.py; bound with
 * ctypes.
 */

#include <stdint.h>
#include <stdlib.h>
#include <math.h>

float seq_sum_f32(const float *x, int64_t n) {
    float acc = 0.0f;
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
