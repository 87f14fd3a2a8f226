// Native host-side I/O kernels for bbmap_tpu.
//
// The reference offloads its host hot loops to C via JNI (reference:
// jni/MultiStateAligner11tsJNI.c, jni/BBMergeOverlapper.c); in this
// framework the alignment kernels run on the device (XLA), and the
// host-side hot loops are the text codecs. This library provides:
//
//  - fastq_scan:    single-pass FASTQ record boundary scanner (memchr)
//  - revcomp_batch: in-place reverse complement over a padded batch
//  - sam_format_batch: batched SAM line assembly for the fixed columns
//
// Built with `make -C csrc` (plain g++, no external deps), loaded via
// ctypes with a pure-Python fallback (bbmap_tpu/io/native.py).

#include <cstring>
#include <cmath>
#include <cstdint>
#include <cstdio>

extern "C" {

// Scan a FASTQ buffer. For each record, writes 8 longs into `out`:
// header_start, header_len, seq_start, seq_len, plus_start(unused=0),
// 0, qual_start, qual_len. Returns the number of complete records, or
// -(byte_position+1) on a malformed record. `consumed` receives the
// number of bytes consumed by complete records (so callers can carry
// partial tails between chunks).
long fastq_scan(const char* buf, long n, long* out, long max_recs,
                long* consumed) {
    long count = 0;
    long pos = 0;
    *consumed = 0;
    while (pos < n && count < max_recs) {
        long rec_start = pos;
        if (buf[pos] != '@') {
            // skip blank lines
            if (buf[pos] == '\n') { pos++; continue; }
            return -(pos + 1);
        }
        const char* nl1 = (const char*)memchr(buf + pos, '\n', n - pos);
        if (!nl1) break;
        long h_start = pos + 1, h_len = (nl1 - buf) - h_start;
        if (h_len > 0 && buf[h_start + h_len - 1] == '\r') h_len--;
        pos = (nl1 - buf) + 1;
        const char* nl2 = (const char*)memchr(buf + pos, '\n', n - pos);
        if (!nl2) break;
        long s_start = pos, s_len = (nl2 - buf) - s_start;
        if (s_len > 0 && buf[s_start + s_len - 1] == '\r') s_len--;
        pos = (nl2 - buf) + 1;
        if (pos >= n) break;
        if (buf[pos] != '+') return -(pos + 1);
        const char* nl3 = (const char*)memchr(buf + pos, '\n', n - pos);
        if (!nl3) break;
        pos = (nl3 - buf) + 1;
        const char* nl4 = (const char*)memchr(buf + pos, '\n', n - pos);
        long q_start = pos, q_len;
        if (!nl4) {
            // allow final record without trailing newline only if the
            // quality line is complete (same length as seq)
            q_len = n - pos;
            if (q_len < s_len) break;
            q_len = s_len;
            pos = q_start + q_len;
        } else {
            q_len = (nl4 - buf) - q_start;
            if (q_len > 0 && buf[q_start + q_len - 1] == '\r') q_len--;
            pos = (nl4 - buf) + 1;
        }
        long* o = out + count * 8;
        o[0] = h_start; o[1] = h_len;
        o[2] = s_start; o[3] = s_len;
        o[4] = 0;       o[5] = 0;
        o[6] = q_start; o[7] = q_len;
        count++;
        *consumed = pos;
        (void)rec_start;
    }
    return count;
}

static unsigned char COMP[256];
static int comp_init_done = 0;
static void comp_init() {
    for (int i = 0; i < 256; i++) COMP[i] = (unsigned char)i;
    COMP['A'] = 'T'; COMP['T'] = 'A'; COMP['C'] = 'G'; COMP['G'] = 'C';
    COMP['a'] = 't'; COMP['t'] = 'a'; COMP['c'] = 'g'; COMP['g'] = 'c';
    comp_init_done = 1;
}

// Reverse-complement rows of a (B, L) uint8 matrix in place, each within
// its own length lens[b] (tail padding untouched).
void revcomp_batch(unsigned char* mat, long B, long L, const int* lens) {
    if (!comp_init_done) comp_init();
    for (long b = 0; b < B; b++) {
        unsigned char* row = mat + b * L;
        long len = lens[b];
        for (long i = 0, j = len - 1; i < j; i++, j--) {
            unsigned char x = COMP[row[i]], y = COMP[row[j]];
            row[i] = y; row[j] = x;
        }
        if (len & 1) row[len / 2] = COMP[row[len / 2]];
    }
}

// Assemble SAM lines for a batch. Inputs are parallel arrays; text
// fields (qname, rname, cigar, tags) come as one concatenated blob each
// with offsets. seq/qual are (B, Lmax) matrices with per-row lengths;
// rows with revcomp[b] != 0 are emitted reverse-complemented (seq) and
// reversed (qual). Returns bytes written, or -needed if `cap` too small.
long sam_format_batch(
    long B,
    const char* qname_blob, const long* qname_off,
    const int* flag,
    const char* rname_blob, const long* rname_off,
    const long* pos, const int* mapq,
    const char* cigar_blob, const long* cigar_off,
    const char* rnext_blob, const long* rnext_off,
    const long* pnext, const long* tlen,
    const unsigned char* seq, const unsigned char* qual,
    long Lmax, const int* lens, const unsigned char* do_rc,
    const char* tags_blob, const long* tags_off,
    char* out, long cap) {
    if (!comp_init_done) comp_init();
    long w = 0;
    #define NEED(k) if (w + (k) > cap) return -(w + (k));
    #define PUTS(p, l) { NEED(l); memcpy(out + w, (p), (l)); w += (l); }
    #define PUTC(c) { NEED(1); out[w++] = (c); }
    char numbuf[24];
    for (long b = 0; b < B; b++) {
        PUTS(qname_blob + qname_off[b],
             qname_off[b + 1] - qname_off[b]); PUTC('\t');
        int k = snprintf(numbuf, sizeof numbuf, "%d\t", flag[b]);
        PUTS(numbuf, k);
        PUTS(rname_blob + rname_off[b],
             rname_off[b + 1] - rname_off[b]); PUTC('\t');
        k = snprintf(numbuf, sizeof numbuf, "%ld\t%d\t", pos[b], mapq[b]);
        PUTS(numbuf, k);
        PUTS(cigar_blob + cigar_off[b],
             cigar_off[b + 1] - cigar_off[b]); PUTC('\t');
        PUTS(rnext_blob + rnext_off[b],
             rnext_off[b + 1] - rnext_off[b]); PUTC('\t');
        k = snprintf(numbuf, sizeof numbuf, "%ld\t%ld\t", pnext[b],
                     tlen[b]);
        PUTS(numbuf, k);
        long len = lens[b];
        NEED(2 * len + 2);
        const unsigned char* srow = seq + b * Lmax;
        const unsigned char* qrow = qual + b * Lmax;
        if (do_rc[b]) {
            for (long i = 0; i < len; i++)
                out[w + i] = (char)COMP[srow[len - 1 - i]];
            w += len; out[w++] = '\t';
            for (long i = 0; i < len; i++)
                out[w + i] = (char)qrow[len - 1 - i];
            w += len;
        } else {
            memcpy(out + w, srow, len); w += len; out[w++] = '\t';
            memcpy(out + w, qrow, len); w += len;
        }
        long tl = tags_off[b + 1] - tags_off[b];
        if (tl > 0) { PUTC('\t'); PUTS(tags_blob + tags_off[b], tl); }
        PUTC('\n');
    }
    #undef NEED
    #undef PUTS
    #undef PUTC
    return w;
}

// Quality-probability key selection + Solver key scores, host twin of
// the device quality stage (bbmap_tpu/align/quickmap_device.py
// _quality_offsets_core; reference: QualityTools.makeKeyProbs:188-218,
// KeyRing.makeOffsets3:396-506, AbstractMapThread.java:704-727). All
// float arithmetic is float32 in Java source order (the Makefile sets
// -ffp-contract=off so no fused multiply-adds sneak in) — results are
// bit-identical to the device/XLA implementation, asserted by
// tests/test_quality_seeding.py.
//
// q: (B, qstride) int8 phred. prob_correct: 128-entry float table
// (seed.PROB_CORRECT). ladder: (nk,) default offsets (the fallback for
// reads whose offset selection fails). Outputs: out_off (B, nk) int16
// (-1 unused), out_scores (B, nk) int16, out_reject (B,) uint8.
void quality_offsets_scores(const signed char* q, long B, long qstride,
                            int L, int k, const float* prob_correct,
                            const int* ladder, int nk,
                            double max_density, int a,
                            short* out_off, short* out_scores,
                            unsigned char* out_reject) {
    const int m = L - k + 1;
    const float l1 = 0.94f, l2 = 0.9999f;
    const int base_ks = a / 8;
    const int range_ks = a - base_ks;
    #ifdef _OPENMP
    #pragma omp parallel for schedule(static)
    #endif
    for (long b = 0; b < B; b++) {
        const signed char* qr = q + b * qstride;
        float pc[1024];
        float probs[1024];
        for (int i = 0; i < L; i++) {
            int qi = qr[i];
            if (qi < 0) qi = 0;
            if (qi > 127) qi = 127;
            pc[i] = prob_correct[qi];
        }
        // window products as k-1 vectorizable array passes — same
        // multiply order as the sequential form (pass t multiplies
        // pc[j+t] onto the running product, ascending t)
        unsigned char hz[1024];
        for (int j = 0; j < m; j++) { probs[j] = pc[j]; hz[j] = qr[j] == 0; }
        for (int t = 1; t < k; t++) {
            const float* pt = pc + t;
            const signed char* qt = qr + t;
            for (int j = 0; j < m; j++) {
                probs[j] = probs[j] * pt[j];
                hz[j] |= (qt[j] == 0);
            }
        }
        for (int j = 0; j < m; j++)
            probs[j] = hz[j] ? 1.0f : (1.0f - probs[j]);
        // window trim + desired-key count (device _quality_offsets_core)
        int left = -1, right = -1, potential = 0;
        for (int j = 0; j < m; j++)
            if (probs[j] < l1) { left = j; break; }
        for (int j = m - 1; j >= 0; j--)
            if (probs[j] < l1) { right = j; break; }
        if (left >= 0 && right >= left)
            for (int j = left; j <= right; j++)
                if (probs[j] < l2) potential++;
        int valid = (left >= 0) && (potential > 0) && (right >= left);
        short* off_row = out_off + b * nk;
        short* sc_row = out_scores + b * nk;
        if (!valid) {
            // ladder fallback (documented deviation: the reference
            // drops these reads; we map them with the static ladder)
            for (int i = 0; i < nk; i++) {
                int o = ladder[i];
                off_row[i] = (short)o;
                float p = probs[o < m ? o : m - 1];
                sc_row[i] = (short)(base_ks + (int)floorf(
                    (float)range_ks * (1.0f - p) + 0.5f));
            }
            out_reject[b] = 0;
            continue;
        }
        int usable = right - left + k;
        int slots_u = usable - k + 1;
        // double precision like the host seed.desired_keys_from_density
        // (the framework's established semantics; the Java computes this
        // in float32 — rare ulp-edge deviation shared with the device)
        int d2 = (int)ceil((double)usable * max_density / (double)k);
        if (d2 < 2) d2 = 2;
        if (d2 > slots_u) d2 = slots_u;
        int desired = (usable < L) ? (d2 < nk ? d2 : nk) : nk;
        if (desired > potential) desired = potential;
        if (desired < 1) desired = 1;
        float interval = (float)(right - left)
            / (float)(desired - 1 > 1 ? desired - 1 : 1);
        int interval_int = (int)interval + 1;
        float f = (float)left;
        int prev = -1, j = left;
        float pae = 1.0f;
        for (int i = 0; i < nk; i++) {
            int active = (i < desired);
            int x = -1;
            if (active && prev < j) {
                int jc = j < m - 1 ? j : m - 1;
                if (jc < 0) jc = 0;
                if (probs[jc] < l2) {
                    x = j;
                } else {
                    for (int kk = j - 1; kk > prev + 2; kk--)
                        if (probs[kk] < l2) { x = kk; break; }
                    if (x < 0) {
                        int lim = j + interval_int;
                        if (lim > right) lim = right;
                        for (int kk = j + 1; kk < lim; kk++)
                            if (probs[kk] < l2) { x = kk; break; }
                    }
                }
            }
            off_row[i] = (short)x;
            float p = 1.0f;
            if (x > -1) {
                int xc = x < m - 1 ? x : m - 1;
                p = probs[xc];
                pae = pae * p;
            }
            sc_row[i] = (short)(base_ks + (int)floorf(
                (float)range_ks * (1.0f - p) + 0.5f));
            if (active) {
                if (x > -1) prev = x;
                else if (j - 2 > prev) prev = j - 2;
                f = f + interval;
                int jn = (int)floorf(f + 0.5f);
                if (jn < j + 1) jn = j + 1;
                if (jn > m - 1) jn = m - 1;
                j = jn;
            }
        }
        out_reject[b] = pae > 0.5f ? 1 : 0;
    }
}

}  // extern "C"
