// Native BAM ingest accelerator.
//
// The reference leans on htslib (C) for BGZF + BAM decode
// (file_reader.rs:12-16); this is the equivalent native layer for the
// build: a zlib-based BGZF inflater and a BAM record scanner that returns
// flat arrays over ctypes, so the Python ingest layer only does numpy
// slicing. Python keeps a pure fallback (floria_tpu/ingest/bam.py).
//
// Build: make -C native   (produces libfloria_native.so)

#include <cstdint>
#include <cstring>
#include <cstdio>
#include <thread>
#include <vector>
#include <zlib.h>

namespace {

inline int64_t lower_bound_i64(const int64_t* arr, int64_t n,
                               int64_t key) {
    int64_t lo = 0, hi = n;
    while (lo < hi) {
        int64_t mid = (lo + hi) >> 1;
        if (arr[mid] < key) lo = mid + 1; else hi = mid;
    }
    return lo;
}

}  // namespace

extern "C" {

// Inflate a BGZF/concatenated-gzip stream. Returns total decompressed
// size, or -1 on error. If out == nullptr, only sizes the output.
int64_t floria_bgzf_inflate(const uint8_t* data, int64_t len, uint8_t* out,
                            int64_t out_cap) {
    int64_t pos = 0;
    int64_t total = 0;
    while (pos < len) {
        z_stream zs;
        std::memset(&zs, 0, sizeof(zs));
        if (inflateInit2(&zs, 15 + 16) != Z_OK) return -1;
        zs.next_in = const_cast<uint8_t*>(data + pos);
        zs.avail_in = static_cast<uInt>(len - pos);
        int ret = Z_OK;
        uint8_t sink[1 << 16];
        while (ret != Z_STREAM_END) {
            if (out != nullptr) {
                zs.next_out = out + total;
                zs.avail_out = static_cast<uInt>(out_cap - total);
            } else {
                zs.next_out = sink;
                zs.avail_out = sizeof(sink);
            }
            uLong before = zs.total_out;
            ret = inflate(&zs, Z_NO_FLUSH);
            total += static_cast<int64_t>(zs.total_out - before);
            if (ret != Z_OK && ret != Z_STREAM_END) {
                inflateEnd(&zs);
                return -1;
            }
            if (out != nullptr && total > out_cap) {
                inflateEnd(&zs);
                return -1;
            }
        }
        pos += static_cast<int64_t>(zs.next_in - (data + pos));
        inflateEnd(&zs);
    }
    return total;
}

// Index a BGZF stream without inflating: walk the gzip members using the
// BC extra subfield (BSIZE = total member size - 1) and read each
// member's trailing ISIZE. Fills in_off[i] (member byte offset) and
// out_size[i] (uncompressed size). Returns the member count, -needed if
// cap is too small, or -1 for streams that are not block-gzip (no BC
// subfield) — callers then fall back to the serial inflater above.
int64_t floria_bgzf_index(const uint8_t* data, int64_t len, int64_t* in_off,
                          int64_t* out_size, int64_t cap) {
    int64_t pos = 0;
    int64_t n = 0;
    while (pos < len) {
        if (pos + 18 > len) return -1;
        const uint8_t* h = data + pos;
        if (h[0] != 0x1f || h[1] != 0x8b || h[2] != 8 || !(h[3] & 4))
            return -1;
        uint16_t xlen;
        std::memcpy(&xlen, h + 10, 2);
        if (pos + 12 + xlen > len) return -1;
        int64_t bsize = -1;
        const uint8_t* x = h + 12;
        int64_t xrem = xlen;
        while (xrem >= 4) {
            uint16_t slen;
            std::memcpy(&slen, x + 2, 2);
            if (x[0] == 66 && x[1] == 67 && slen == 2) {
                uint16_t bs;
                std::memcpy(&bs, x + 4, 2);
                bsize = static_cast<int64_t>(bs) + 1;
                break;
            }
            x += 4 + slen;
            xrem -= 4 + slen;
        }
        if (bsize < 0 || pos + bsize > len) return -1;
        if (n >= cap) return -(n + 1);
        uint32_t isize;
        std::memcpy(&isize, data + pos + bsize - 4, 4);
        in_off[n] = pos;
        out_size[n] = isize;
        ++n;
        pos += bsize;
    }
    return n;
}

// Inflate indexed BGZF members in parallel (members are independent gzip
// streams). out_off[i] is the destination offset of member i; callers
// compute it as the prefix sum of floria_bgzf_index's out_size. Returns
// 0, or -1 if any member fails to inflate to exactly its stated size.
int32_t floria_bgzf_inflate_blocks(const uint8_t* data, int64_t len,
                                   const int64_t* in_off,
                                   const int64_t* out_off,
                                   const int64_t* out_size, int64_t n,
                                   uint8_t* out, int32_t n_threads) {
    if (n_threads < 1) n_threads = 1;
    std::vector<int> errs(n_threads, 0);
    auto work = [&](int t) {
        z_stream zs;
        for (int64_t i = t; i < n; i += n_threads) {
            std::memset(&zs, 0, sizeof(zs));
            if (inflateInit2(&zs, 15 + 16) != Z_OK) { errs[t] = 1; return; }
            zs.next_in = const_cast<uint8_t*>(data + in_off[i]);
            zs.avail_in = static_cast<uInt>(
                (i + 1 < n ? in_off[i + 1] : len) - in_off[i]);
            zs.next_out = out + out_off[i];
            zs.avail_out = static_cast<uInt>(out_size[i]);
            int ret = inflate(&zs, Z_FINISH);
            if (ret != Z_STREAM_END
                || static_cast<int64_t>(zs.total_out) != out_size[i])
                errs[t] = 1;
            inflateEnd(&zs);
            if (errs[t]) return;
        }
    };
    std::vector<std::thread> threads;
    for (int t = 1; t < n_threads; ++t) threads.emplace_back(work, t);
    work(0);
    for (auto& th : threads) th.join();
    for (int t = 0; t < n_threads; ++t)
        if (errs[t]) return -1;
    return 0;
}

// Pack realignment query windows: for each job, gather WINDOW=2*flank
// ASCII bases at qpos[i]-flank .. qpos[i]+flank from the concatenated
// payload buffer, 4-bit encode them (BAM nibble alphabet, unknown -> N),
// and pack two codes per output byte (even index = low nibble). Mirrors
// kernels/realign.py's _ENC/_pack4 numpy path, which remains the
// fallback. Bounds are the caller's contract (the ok mask in
// add_jobs_bulk).
void floria_pack_windows(const uint8_t* seq, const int64_t* qpos,
                         int64_t n, int32_t flank, uint8_t* out,
                         int32_t n_threads) {
    static uint8_t enc[256];
    static bool init = false;
    if (!init) {
        static const char alphabet[17] = "=ACMGRSVTWYHKDBN";
        std::memset(enc, 15, sizeof(enc));
        for (int i = 0; i < 16; ++i)
            enc[static_cast<uint8_t>(alphabet[i])] =
                static_cast<uint8_t>(i);
        init = true;
    }
    const int64_t w2 = flank;  // packed bytes per job = WINDOW/2
    if (n_threads < 1) n_threads = 1;
    auto work = [&](int64_t lo, int64_t hi) {
        for (int64_t i = lo; i < hi; ++i) {
            const uint8_t* src = seq + qpos[i] - flank;
            uint8_t* dst = out + i * w2;
            for (int64_t j = 0; j < w2; ++j)
                dst[j] = static_cast<uint8_t>(
                    enc[src[2 * j]] | (enc[src[2 * j + 1]] << 4));
        }
    };
    if (n_threads == 1 || n < (1 << 15)) {
        work(0, n);
        return;
    }
    std::vector<std::thread> threads;
    int64_t per = (n + n_threads - 1) / n_threads;
    for (int t = 1; t < n_threads; ++t)
        threads.emplace_back(work, per * t,
                             std::min<int64_t>(n, per * (t + 1)));
    work(0, std::min<int64_t>(n, per));
    for (auto& th : threads) th.join();
}

// Single-pass realignment job builder: fuses add_jobs_bulk's bounds
// mask, window gather+4-bit pack, SNP-row/allele-count lookups, and
// kept-site compaction (kernels/realign.py add_jobs_bulk, whose numpy
// version remains the fallback). One parallel sweep writes each output
// byte exactly once — on VMs where fresh-page first-touch is the real
// cost, this beats the ~10 full-size numpy temporaries the fallback
// allocates. Outputs are compacted to the kept jobs in site order;
// kept[] is the per-input-site mask for the caller's per-record split.
// Returns the number of kept jobs.
int64_t floria_realign_jobs(
    const uint8_t* seq, const int32_t* rec, const int32_t* qpos,
    const int32_t* snp, int64_t n, const int64_t* pay_offs,
    const int64_t* genome_pos, int64_t ref_len,
    const int32_t* n_alleles, int32_t flank, int32_t tab_base,
    uint8_t* kept, uint8_t* packed, int32_t* si, int32_t* nal,
    int32_t* snp_kept, int32_t* rec_counts, int32_t n_threads) {
    static uint8_t enc[256];
    static bool init = false;
    if (!init) {
        static const char alphabet[17] = "=ACMGRSVTWYHKDBN";
        std::memset(enc, 15, sizeof(enc));
        for (int i = 0; i < 16; ++i)
            enc[static_cast<uint8_t>(alphabet[i])] =
                static_cast<uint8_t>(i);
        init = true;
    }
    const int64_t w2 = flank;  // packed bytes per job = WINDOW/2
    if (n_threads < 1) n_threads = 1;
    if (n < (1 << 15)) n_threads = 1;
    const int T = n_threads;
    std::vector<int64_t> cnt(T, 0);
    const int64_t per = (n + T - 1) / T;
    auto pass1 = [&](int t) {
        const int64_t lo = per * t, hi = std::min<int64_t>(n, per * (t + 1));
        int64_t c = 0;
        for (int64_t k = lo; k < hi; ++k) {
            const int64_t gp = genome_pos[snp[k]];
            const int64_t q0 = pay_offs[rec[k]] + qpos[k];
            const bool ok = gp >= flank && gp + flank < ref_len &&
                            qpos[k] >= flank &&
                            q0 + flank < pay_offs[rec[k] + 1];
            kept[k] = ok;
            c += ok;
        }
        cnt[t] = c;
    };
    {
        std::vector<std::thread> threads;
        for (int t = 1; t < T; ++t) threads.emplace_back(pass1, t);
        pass1(0);
        for (auto& th : threads) th.join();
    }
    std::vector<int64_t> offs(T + 1, 0);
    for (int t = 0; t < T; ++t) offs[t + 1] = offs[t] + cnt[t];
    auto pass2 = [&](int t) {
        const int64_t lo = per * t, hi = std::min<int64_t>(n, per * (t + 1));
        int64_t o = offs[t];
        for (int64_t k = lo; k < hi; ++k) {
            if (!kept[k]) continue;
            const uint8_t* src = seq + pay_offs[rec[k]] + qpos[k] - flank;
            uint8_t* dst = packed + o * w2;
            for (int64_t j = 0; j < w2; ++j)
                dst[j] = static_cast<uint8_t>(
                    enc[src[2 * j]] | (enc[src[2 * j + 1]] << 4));
            si[o] = tab_base + snp[k];
            nal[o] = n_alleles[snp[k]];
            snp_kept[o] = snp[k] + 1;
            ++o;
        }
    };
    {
        std::vector<std::thread> threads;
        for (int t = 1; t < T; ++t) threads.emplace_back(pass2, t);
        pass2(0);
        for (auto& th : threads) th.join();
    }
    // Per-record kept counts (caller-zeroed): the caller's per-record
    // split needs cumulative kept offsets, and a host cumsum over the
    // 10-50M-site kept mask costs more than this sequential tally.
    if (rec_counts != nullptr)
        for (int64_t k = 0; k < n; ++k) rec_counts[rec[k]] += kept[k];
    return offs[T];
}

// Exact batched affine-gap NW matching kernels/realign.py's device
// recurrence cell for cell (same transition set: Ix opens from M only,
// Iy opens from M or Ix; boundary rows identical; integer scores), so
// best-allele results are identical to the device kernel. Used for job
// partitions too small to amortize a padded device dispatch. q is
// 4-bit packed [n, w2]; ref/allele tables are code (not packed) rows.
int64_t floria_nw_batch(const uint8_t* q, const int32_t* si,
                        const int32_t* nal, const uint8_t* ref_tab,
                        const uint8_t* al_tab, int64_t n, int32_t max_a,
                        int32_t w2, int8_t* out_best,
                        int32_t n_threads) {
    const int W = 2 * w2;
    const int GO = -2, GE = -1, MA = 1, MI = -1;
    const int NEGI = -16384;
    auto work = [&](int64_t lo_i, int64_t hi_i) {
        std::vector<int> M(W + 1), Ix(W + 1), Iy(W + 1);
        std::vector<uint8_t> qc(W), var(W);
        for (int64_t i = lo_i; i < hi_i; ++i) {
            const uint8_t* qp = q + i * w2;
            for (int j = 0; j < w2; ++j) {
                qc[2 * j] = qp[j] & 0xF;
                qc[2 * j + 1] = qp[j] >> 4;
            }
            const uint8_t* ref = ref_tab + static_cast<int64_t>(si[i]) * W;
            const uint8_t* als =
                al_tab + static_cast<int64_t>(si[i]) * max_a;
            int best_score = NEGI;
            int8_t best = 0;
            int na = nal[i] < max_a ? nal[i] : max_a;
            for (int a = 0; a < na; ++a) {
                std::memcpy(var.data(), ref, W);
                var[w2] = als[a];  // center = FLANK = W/2 = w2
                // boundary row 0
                M[0] = 0; Ix[0] = NEGI; Iy[0] = NEGI;
                for (int j = 1; j <= W; ++j) {
                    M[j] = NEGI; Ix[j] = NEGI;
                    Iy[j] = GO + GE * (j - 1);
                }
                for (int ii = 1; ii <= W; ++ii) {
                    int diagM = M[0], diagIx = Ix[0], diagIy = Iy[0];
                    M[0] = NEGI;
                    Ix[0] = GO + GE * (ii - 1);
                    Iy[0] = NEGI;
                    for (int j = 1; j <= W; ++j) {
                        int pm = M[j], pix = Ix[j], piy = Iy[j];
                        int h = diagM > diagIx ? diagM : diagIx;
                        if (diagIy > h) h = diagIy;
                        int sub = (qc[ii - 1] == var[j - 1]) ? MA : MI;
                        int m_new = h + sub;
                        int ix_new = pm + GO;
                        if (pix + GE > ix_new) ix_new = pix + GE;
                        int iy_open = M[j - 1] > Ix[j - 1]
                                          ? M[j - 1] : Ix[j - 1];
                        int iy_new = iy_open + GO;
                        if (Iy[j - 1] + GE > iy_new)
                            iy_new = Iy[j - 1] + GE;
                        M[j] = m_new; Ix[j] = ix_new; Iy[j] = iy_new;
                        diagM = pm; diagIx = pix; diagIy = piy;
                    }
                }
                int sc = M[W] > Ix[W] ? M[W] : Ix[W];
                if (Iy[W] > sc) sc = Iy[W];
                if (sc > best_score) { best_score = sc; best = a; }
            }
            out_best[i] = best;
        }
    };
    if (n_threads < 1) n_threads = 1;
    if (n_threads == 1 || n < 4096) {
        work(0, n);
    } else {
        std::vector<std::thread> threads;
        int64_t per = (n + n_threads - 1) / n_threads;
        for (int t = 1; t < n_threads; ++t)
            threads.emplace_back(work, per * t,
                                 std::min<int64_t>(n, per * (t + 1)));
        work(0, std::min<int64_t>(n, per));
        for (auto& th : threads) th.join();
    }
    return n;
}

// VCF SNP scan (file_reader.rs:116-181 semantics, matching
// ingest/vcf.py::read_vcf): for each non-header line, keep records
// whose REF and every comma-separated ALT are single bases in
// [ACGTacgt] (case preserved in the stored allele bytes). Emits flat
// arrays: pos (0-based), per-record allele bytes (concatenated, with
// end offsets), and a contig RUN id that increments whenever CHROM
// differs from the previous kept record's CHROM; run names are
// concatenated into name_buf with end offsets. Two-pass: with null
// outputs only counts (returns n_records; *n_runs_out = runs,
// *n_allele_bytes_out = total allele bytes, *n_name_bytes_out = total
// run-name bytes).
int64_t floria_parse_vcf(const uint8_t* data, int64_t len,
                         int64_t* n_runs_out,
                         int64_t* n_allele_bytes_out,
                         int64_t* n_name_bytes_out, int64_t* pos_out,
                         uint8_t* allele_buf, int64_t* allele_end,
                         int32_t* run_id, uint8_t* name_buf,
                         int64_t* name_end) {
    auto is_base = [](uint8_t c) {
        switch (c) {
            case 'A': case 'C': case 'G': case 'T':
            case 'a': case 'c': case 'g': case 't': return true;
            default: return false;
        }
    };
    bool counting = pos_out == nullptr;
    int64_t n = 0, runs = 0, abytes = 0, nbytes = 0;
    const uint8_t* prev_chrom = nullptr;
    int64_t prev_chrom_len = -1;
    int64_t i = 0;
    while (i < len) {
        int64_t eol = i;
        while (eol < len && data[eol] != '\n') ++eol;
        int64_t ll = eol - i;
        if (ll > 0 && data[i] != '#') {
            // fields: CHROM \t POS \t ID \t REF \t ALT \t ...
            int64_t f[6];
            int nf = 0;
            f[nf++] = i;
            for (int64_t j = i; j < eol && nf < 6; ++j)
                if (data[j] == '\t') f[nf++] = j + 1;
            if (nf >= 5) {
                const uint8_t* chrom = data + f[0];
                int64_t chrom_len = f[1] - 1 - f[0];
                int64_t ref_len = f[4] - 1 - f[3];
                int64_t alt_end = (nf == 6 ? f[5] - 1 : eol);
                bool ok = ref_len == 1 && is_base(data[f[3]]);
                uint8_t albuf[64];
                int na = 0;
                if (ok) {
                    albuf[na++] = data[f[3]];
                    int64_t a = f[4];
                    while (ok && a < alt_end) {
                        int64_t b = a;
                        while (b < alt_end && data[b] != ',') ++b;
                        if (b - a != 1 || !is_base(data[a]) || na >= 64)
                            ok = false;
                        else
                            albuf[na++] = data[a];
                        a = b + 1;
                    }
                }
                if (ok) {
                    int64_t pos = 0;
                    for (int64_t j = f[1]; j < f[2] - 1; ++j) {
                        uint8_t c = data[j];
                        if (c < '0' || c > '9') { pos = -1; break; }
                        pos = pos * 10 + (c - '0');
                    }
                    if (pos > 0) {
                        bool new_run = prev_chrom == nullptr
                            || chrom_len != prev_chrom_len
                            || std::memcmp(chrom, prev_chrom,
                                           chrom_len) != 0;
                        if (new_run) {
                            if (!counting) {
                                std::memcpy(name_buf + nbytes, chrom,
                                            chrom_len);
                                name_end[runs] = nbytes + chrom_len;
                            }
                            nbytes += chrom_len;
                            ++runs;
                            prev_chrom = chrom;
                            prev_chrom_len = chrom_len;
                        }
                        if (!counting) {
                            pos_out[n] = pos - 1;  // VCF POS is 1-based
                            std::memcpy(allele_buf + abytes, albuf, na);
                            allele_end[n] = abytes + na;
                            run_id[n] = static_cast<int32_t>(runs - 1);
                        }
                        abytes += na;
                        ++n;
                    }
                }
            }
        }
        i = eol + 1;
    }
    if (n_runs_out) *n_runs_out = runs;
    if (n_allele_bytes_out) *n_allele_bytes_out = abytes;
    if (n_name_bytes_out) *n_name_bytes_out = nbytes;
    return n;
}

// Range-restricted CSR gather: for each fragment id, binary-search its
// ascending SNP segment for [lo, hi] and copy only the in-range rows
// (snp, allele, weight, frag-row). Replaces gather-everything-then-mask
// in the hap-graph join, where blocks touch only ~1/3 of their reads'
// sites. Returns the number of rows written.
int64_t floria_csr_gather_range(
    const int64_t* snps, const int8_t* alleles, const float* weights,
    const int64_t* off, const int64_t* fids, int64_t n_fids, int64_t lo,
    int64_t hi, int64_t* out_snps, int8_t* out_alleles,
    float* out_weights, int32_t* out_ridx) {
    // Counting mode (null outputs): exact in-range total via two binary
    // searches per frag, so the Python wrapper can allocate exact-size
    // outputs instead of a worst-case total-sites buffer (gigabytes for
    // contig-spanning parts, and fresh-page faults dwarf the gather).
    if (out_snps == nullptr) {
        int64_t w = 0;
        for (int64_t k = 0; k < n_fids; ++k) {
            int64_t f = fids[k];
            int64_t a = off[f], b = off[f + 1];
            int64_t s = a + lower_bound_i64(snps + a, b - a, lo);
            int64_t e = a + lower_bound_i64(snps + a, b - a, hi + 1);
            w += e - s;
        }
        return w;
    }
    int64_t w = 0;
    for (int64_t k = 0; k < n_fids; ++k) {
        int64_t f = fids[k];
        int64_t a = off[f], b = off[f + 1];
        int64_t s = a + lower_bound_i64(snps + a, b - a, lo);
        for (int64_t i = s; i < b && snps[i] <= hi; ++i) {
            out_snps[w] = snps[i];
            out_alleles[w] = alleles[i];
            out_weights[w] = weights[i];
            out_ridx[w] = static_cast<int32_t>(k);
            ++w;
        }
    }
    return w;
}

// Windowed consensus accumulation without materializing the gathered
// rows: counts[(s-lo)*A + a] += weight (or 1.0) and exist += 1 over the
// in-range sites of the given frags, in (frag order, ascending SNP)
// order — the exact addition sequence of np.bincount over the gathered
// rows (both widen each float32 weight to double then accumulate
// sequentially), so results are bit-identical to the numpy path.
// out_counts/out_exist must be zeroed by the caller. Returns the entry
// count.
int64_t floria_csr_counts(
    const int64_t* snps, const int8_t* alleles, const float* weights,
    const int64_t* off, const int64_t* fids, int64_t n_fids, int64_t lo,
    int64_t hi, int32_t A, int32_t weighted, double* out_counts,
    int32_t* out_exist) {
    int64_t w = 0;
    for (int64_t k = 0; k < n_fids; ++k) {
        int64_t f = fids[k];
        int64_t a = off[f], b = off[f + 1];
        int64_t s = a + lower_bound_i64(snps + a, b - a, lo);
        for (int64_t i = s; i < b && snps[i] <= hi; ++i) {
            const int64_t slot = (snps[i] - lo) * A + alleles[i];
            out_counts[slot] += weighted
                ? static_cast<double>(weights[i]) : 1.0;
            ++out_exist[slot];
            ++w;
        }
    }
    return w;
}

// Deduplicate realignment jobs by (packed window, SNP row): reads
// covering the same SNP with identical (error-free) windows are the
// same NW problem. Open-addressing hash over the 20-byte keys; fills
// inverse[i] = dense unique index and uniq_idx[u] = a representative
// job index. Returns the unique count.
int64_t floria_dedup_jobs(const uint8_t* q, const int32_t* si, int64_t n,
                          int32_t w2, int64_t* uniq_idx,
                          int64_t* inverse) {
    int64_t cap = 1;
    while (cap < 2 * n) cap <<= 1;
    std::vector<int64_t> table(cap, -1);
    int64_t n_uniq = 0;
    const uint64_t mul = 0x9E3779B97F4A7C15ULL;
    for (int64_t i = 0; i < n; ++i) {
        const uint8_t* key = q + i * w2;
        uint64_t h = static_cast<uint64_t>(si[i]) * mul;
        for (int32_t j = 0; j + 8 <= w2; j += 8) {
            uint64_t v;
            std::memcpy(&v, key + j, 8);
            h = (h ^ v) * mul;
        }
        h ^= h >> 29;
        int64_t slot = static_cast<int64_t>(h & (cap - 1));
        for (;;) {
            int64_t u = table[slot];
            if (u < 0) {
                table[slot] = n_uniq;
                uniq_idx[n_uniq] = i;
                inverse[i] = n_uniq;
                ++n_uniq;
                break;
            }
            int64_t rep = uniq_idx[u];
            if (si[rep] == si[i]
                && std::memcmp(q + rep * w2, key, w2) == 0) {
                inverse[i] = u;
                break;
            }
            slot = (slot + 1) & (cap - 1);
        }
    }
    return n_uniq;
}

// Format vartig_info.txt per-site lines (file_writer.rs:308-369), byte-
// identical to the Python f-string loop it accelerates:
//   "{pos}:{gpos}\t{best}\t{a}:{cnt}|{a}:{cnt}\t\n"  (covered sites)
//   "{pos}:{gpos}\t?\tNA\t\n"                        (uncovered)
// gpos[i] < 0 prints "NA". Returns bytes written, or -1 if cap is too
// small.
int64_t floria_format_vartig_info(int64_t left, int64_t n_sites,
                                  const int64_t* gpos, const uint8_t* has,
                                  const int64_t* bests,
                                  const int64_t* cnt,
                                  const uint8_t* present, int32_t max_a,
                                  char* out, int64_t cap) {
    int64_t w = 0;
    for (int64_t s = 0; s < n_sites; ++s) {
        if (cap - w < 32 + 28 * static_cast<int64_t>(max_a)) return -1;
        int64_t pos = left + s;
        w += std::snprintf(out + w, 32, "%lld:",
                           static_cast<long long>(pos));
        if (gpos[s] >= 0)
            w += std::snprintf(out + w, 24, "%lld",
                               static_cast<long long>(gpos[s]));
        else {
            out[w++] = 'N';
            out[w++] = 'A';
        }
        out[w++] = '\t';
        if (!has[s]) {
            std::memcpy(out + w, "?\tNA\t\n", 6);
            w += 6;
            continue;
        }
        w += std::snprintf(out + w, 24, "%lld",
                           static_cast<long long>(bests[s]));
        out[w++] = '\t';
        bool first = true;
        for (int32_t a = 0; a < max_a; ++a) {
            if (!present[s * max_a + a]) continue;
            if (!first) out[w++] = '|';
            first = false;
            w += std::snprintf(out + w, 28, "%d:%lld", a,
                               static_cast<long long>(
                                   cnt[s * max_a + a]));
        }
        out[w++] = '\t';
        out[w++] = '\n';
    }
    return w;
}

// Resolve realignment jobs whose NW argmax is provable from hamming
// distances alone, without running the DP. With the reference's scores
// (alignment.rs:16-19: match +1, mismatch -1, gap open -2, extend -1)
// on equal-length W-base windows:
//   - a GAPLESS alignment of query vs variant scores exactly W - 2h
//     (h = hamming distance);
//   - ANY alignment using gaps scores <= W - 5: equal lengths force
//     #ins == #del chars (G of each) in >= 2 runs, costing
//     -(2G + n_runs) <= -5 with at most W - G aligned pairs, so
//     score <= W - 3G - n_runs <= W - 5.
// Hence NW(q, v_a) == W - 2*h_a whenever h_a <= 2 (gapless beats every
// gapped candidate), and any variant with h_b >= 3 scores <= W - 5
// < W - 4. So if min_a h_a <= 2 the full argmax is decided: it is the
// first (lowest-index) variant attaining the minimum hamming distance,
// matching jnp.argmax's first-max tie rule (ties share the same exact
// score W - 2h). Single-candidate jobs (nal == 1) are trivially 0.
// Exact window matches are the h == 0 case. out_best[i] = allele or -1
// (unresolved, needs the NW). Returns the number resolved. Pinned
// against the exact Gotoh on adversarial repeat/shift windows by
// tests/test_native_nw.py.
int64_t floria_realign_exact(const uint8_t* q, const int32_t* si,
                             const int32_t* nal, const uint8_t* var_tab,
                             int64_t n, int32_t max_a, int32_t w2,
                             int8_t* out_best, int32_t n_threads) {
    if (n_threads < 1) n_threads = 1;
    std::vector<int64_t> counts(n_threads, 0);
    auto work = [&](int t, int64_t lo, int64_t hi) {
        int64_t c = 0;
        for (int64_t i = lo; i < hi; ++i) {
            const uint8_t* qi = q + i * w2;
            const uint8_t* vars =
                var_tab + static_cast<int64_t>(si[i]) * max_a * w2;
            int8_t best = -1;
            int32_t na = nal[i] < max_a ? nal[i] : max_a;
            if (na <= 1) {
                out_best[i] = 0;
                ++c;
                continue;
            }
            int32_t hmin = 3;  // only h <= 2 is decisive
            for (int32_t a = 0; a < na; ++a) {
                const uint8_t* va = vars + a * w2;
                int32_t h = 0;
                for (int32_t b = 0; b < w2 && h < hmin; ++b) {
                    const uint8_t x = qi[b] ^ va[b];
                    h += ((x & 0xF) != 0) + ((x >> 4) != 0);
                }
                if (h < hmin) {  // strict: first-index wins ties
                    hmin = h;
                    best = static_cast<int8_t>(a);
                    if (h == 0) break;
                }
            }
            out_best[i] = best;  // -1 iff hmin stayed 3
            if (best >= 0) ++c;
        }
        counts[t] = c;
    };
    if (n_threads == 1 || n < (1 << 15)) {
        work(0, 0, n);
    } else {
        std::vector<std::thread> threads;
        int64_t per = (n + n_threads - 1) / n_threads;
        for (int t = 1; t < n_threads; ++t)
            threads.emplace_back(work, t, per * t,
                                 std::min<int64_t>(n, per * (t + 1)));
        work(0, 0, std::min<int64_t>(n, per));
        for (auto& th : threads) th.join();
    }
    int64_t total = 0;
    for (auto c : counts) total += c;
    return total;
}

// Scan decoded BAM records starting at `off` (after header+refs).
// Two-pass interface: first call with null outputs fills counts only.
//
// Outputs (parallel arrays over records):
//   rec_off[i]   byte offset of record i body (after block_size field)
//   tid, pos, mapq, flag, n_cigar, l_seq, l_read_name
// Returns number of records, or -1 on malformed input.
int64_t floria_bam_scan(const uint8_t* data, int64_t len, int64_t off,
                        int64_t* rec_off, int32_t* tid, int32_t* pos,
                        uint8_t* mapq, uint16_t* flag, uint16_t* n_cigar,
                        int32_t* l_seq, uint8_t* l_read_name) {
    int64_t n = 0;
    while (off + 4 <= len) {
        int32_t block_size;
        std::memcpy(&block_size, data + off, 4);
        if (block_size < 32 || off + 4 + block_size > len) {
            if (off + 4 == len || block_size == 0) break;
            return -1;
        }
        const uint8_t* p = data + off + 4;
        if (rec_off != nullptr) {
            rec_off[n] = off + 4;
            std::memcpy(tid + n, p, 4);
            std::memcpy(pos + n, p + 4, 4);
            l_read_name[n] = p[8];
            mapq[n] = p[9];
            std::memcpy(n_cigar + n, p + 12, 2);
            std::memcpy(flag + n, p + 14, 2);
            std::memcpy(l_seq + n, p + 16, 4);
        }
        ++n;
        off += 4 + block_size;
    }
    return n;
}

// Unpack 4-bit encoded bases to ASCII for a batch of records.
// seq_off[i] points at the packed sequence of record i in `data`;
// out_off[i] is the destination offset in `out`.
void floria_unpack_seqs(const uint8_t* data, const int64_t* seq_off,
                        const int32_t* l_seq, const int64_t* out_off,
                        int64_t n, uint8_t* out) {
    static const char codes[17] = "=ACMGRSVTWYHKDBN";
    for (int64_t i = 0; i < n; ++i) {
        const uint8_t* src = data + seq_off[i];
        uint8_t* dst = out + out_off[i];
        int32_t L = l_seq[i];
        for (int32_t j = 0; j < L; ++j) {
            uint8_t b = src[j >> 1];
            dst[j] = codes[(j & 1) ? (b & 0xF) : (b >> 4)];
        }
    }
}

// Decode (seq, qual) payloads for a batch of records in one pass:
// ASCII bases into out_seq and phred+33 (clamped at 255) quals into
// out_qual, both at out_off[i]. rec_off[i] is the record body offset as
// produced by floria_bam_scan; the packed sequence starts after the
// fixed 32-byte prefix, read name, and CIGAR words.
void floria_unpack_payloads(const uint8_t* data, const int64_t* rec_off,
                            const uint8_t* l_read_name,
                            const uint16_t* n_cigar, const int32_t* l_seq,
                            const int64_t* out_off, int64_t n,
                            uint8_t* out_seq, uint8_t* out_qual) {
    static const char codes[17] = "=ACMGRSVTWYHKDBN";
    auto work = [&](int64_t lo, int64_t hi) {
        for (int64_t i = lo; i < hi; ++i) {
            int32_t L = l_seq[i];
            const uint8_t* src = data + rec_off[i] + 32 + l_read_name[i]
                                 + 4 * static_cast<int64_t>(n_cigar[i]);
            const uint8_t* q = src + (L + 1) / 2;
            uint8_t* ds = out_seq + out_off[i];
            uint8_t* dq = out_qual + out_off[i];
            for (int32_t j = 0; j < L; ++j) {
                uint8_t b = src[j >> 1];
                ds[j] = codes[(j & 1) ? (b & 0xF) : (b >> 4)];
                int v = q[j] + 33;
                dq[j] = v > 255 ? 255 : static_cast<uint8_t>(v);
            }
        }
    };
    int n_threads = static_cast<int>(
        std::thread::hardware_concurrency());
    if (n_threads < 1) n_threads = 1;
    if (n_threads == 1 || n < 1024) {
        work(0, n);
        return;
    }
    std::vector<std::thread> threads;
    int64_t per = (n + n_threads - 1) / n_threads;
    for (int t = 1; t < n_threads; ++t)
        threads.emplace_back(work, per * t,
                             std::min<int64_t>(n, per * (t + 1)));
    work(0, std::min<int64_t>(n, per));
    for (auto& th : threads) th.join();
}

}  // extern "C"

// ---------------------------------------------------------------------------
// Fragment extraction hot loop: walk each record's CIGAR, intersect match
// segments with the sorted SNP position list, match read bases against the
// VCF allele lists, and emit flat site arrays. Mirrors the semantics of the
// reference's frag_from_record walk (file_reader.rs:661-736): deletions at
// SNPs are skipped, the first matching allele index wins, supplementary
// records offset query positions by leading hard clips.

extern "C" {

// Returns the number of emitted sites (or -needed if cap too small).
// rec_end_out[i] receives the 0-based exclusive reference end per record.
int64_t floria_extract_sites(
    const uint8_t* data, const int64_t* rec_off, int64_t n_rec,
    const int64_t* snp_pos, int64_t n_snp, const uint8_t* allele_mat,
    int32_t max_a, int64_t cap, int32_t* out_rec, int32_t* out_snp,
    uint8_t* out_allele, uint8_t* out_qual, int32_t* out_qpos,
    int64_t* rec_end_out) {
    static const char seq_codes[17] = "=ACMGRSVTWYHKDBN";
    int64_t emitted = 0;
    for (int64_t ri = 0; ri < n_rec; ++ri) {
        const uint8_t* p = data + rec_off[ri];
        int32_t pos;
        std::memcpy(&pos, p + 4, 4);
        uint8_t l_read_name = p[8];
        uint16_t n_cigar, flag;
        std::memcpy(&n_cigar, p + 12, 2);
        std::memcpy(&flag, p + 14, 2);
        int32_t l_seq;
        std::memcpy(&l_seq, p + 16, 4);
        const uint8_t* cigar = p + 32 + l_read_name;
        const uint8_t* seq = cigar + 4 * n_cigar;
        const uint8_t* qual = seq + (l_seq + 1) / 2;

        int32_t lead_hard = 0;
        if ((flag & 2048) && n_cigar > 0) {
            uint32_t op0;
            std::memcpy(&op0, cigar, 4);
            if ((op0 & 0xF) == 5) lead_hard = op0 >> 4;
        }

        int64_t r = pos;
        int64_t q = 0;
        for (int32_t ci = 0; ci < n_cigar; ++ci) {
            uint32_t c;
            std::memcpy(&c, cigar + 4 * ci, 4);
            uint32_t op = c & 0xF, ln = c >> 4;
            bool consumes_q = (op == 0 || op == 1 || op == 4 || op == 7
                               || op == 8);
            bool consumes_r = (op == 0 || op == 2 || op == 3 || op == 7
                               || op == 8);
            if (consumes_q && consumes_r) {  // M/=/X
                int64_t lo = lower_bound_i64(snp_pos, n_snp, r);
                for (int64_t si = lo; si < n_snp
                         && snp_pos[si] < r + ln; ++si) {
                    int64_t qpos = q + (snp_pos[si] - r);
                    uint8_t code = seq[qpos >> 1];
                    uint8_t base = static_cast<uint8_t>(
                        seq_codes[(qpos & 1) ? (code & 0xF)
                                             : (code >> 4)]);
                    const uint8_t* alleles = allele_mat + si * max_a;
                    for (int32_t a = 0; a < max_a; ++a) {
                        if (alleles[a] == 0) break;
                        if (alleles[a] == base) {
                            if (emitted >= cap) return -(emitted + 1);
                            out_rec[emitted] = static_cast<int32_t>(ri);
                            out_snp[emitted] = static_cast<int32_t>(si);
                            out_allele[emitted] = static_cast<uint8_t>(a);
                            out_qual[emitted] = qual[qpos];
                            out_qpos[emitted] = static_cast<int32_t>(
                                qpos + lead_hard);
                            ++emitted;
                            break;
                        }
                    }
                }
            }
            if (consumes_q) q += ln;
            if (consumes_r) r += ln;
        }
        rec_end_out[ri] = r;
    }
    return emitted;
}

}  // extern "C"
