/* fastpack — native signal-ingest packer for bayesian_consensus_engine_tpu_torch.
 *
 * The TPU compute path consumes dense arrays; turning ragged JSON-shaped
 * signal payloads into those arrays is the framework's host-side hot loop
 * (core/batch.py:pack_markets). This module implements that inner loop in C
 * against the CPython API: one pass per market grouping signals by source,
 * sorted-source slot assignment, and flat (signal → pair-slot) emission.
 *
 * Contract: byte-for-byte the same outputs as the pure-Python packer (the
 * fallback when this extension is not built); equivalence is enforced by
 * tests/test_torch_native.py. The reliability lookup stays in Python — it is a
 * user-supplied callable per (source, market) pair, O(pairs) not O(signals).
 *
 * pack(markets) returns, for a list of (market_id, signals) tuples:
 *   pair_market        list[int]   market row per (market, source) pair
 *   pair_source_ids    list[str]   source id per pair (sorted within market)
 *   flat_probs         list[float] raw probabilities in input order
 *   flat_pair          list[int]   pair slot per raw signal
 *   signals_per_market list[int]
 *   pair_offsets       list[int]   pair range per market (len M+1)
 *
 * COLUMNAR FAST PATH (the ingest-floor work). The object-path pack()
 * above is PyObject-bound by construction; the functions below operate
 * on flat columns instead, emitting directly into caller-preallocated
 * buffers (buffer protocol — numpy arrays pass zero-copy), so the only
 * per-signal cost is integer/double arithmetic:
 *
 *   group_columns(codes, rank_of_code, offsets, probs,
 *                 out_signal_pair, out_pair_market, out_pair_rank,
 *                 out_pair_offsets, out_sums, out_counts) -> num_pairs
 *       The grouping pass of core.batch.group_columns: per market,
 *       dedupe signals by source rank, sort the unique ranks (= the
 *       scalar engine's source-id code-point order), assign pair slots,
 *       and accumulate per-pair probability sums IN SIGNAL ORDER (the
 *       float-summation contract np.add.at keeps on the numpy twin).
 *   pair_accumulate(pair_idx, probs, out_sums)
 *       Ordered per-pair probability sum (the probability-only refresh
 *       twin's inner loop; out_sums must arrive zeroed).
 *   columns_from_payloads(payloads) -> (keys, sids, probs_buf, offs_buf)
 *       Dict payloads → flat columns in one C pass (the
 *       core.batch.columns_from_payloads layout; buffers wrap as numpy
 *       float64/int64 with no copy).
 *   join_codes(codes, table) -> bytes
 *       Concatenated UTF-8 of table[code] per signal — the
 *       topology_fingerprint joined-id bytes for the zero-copy coded
 *       intake, without materialising a Python string per signal.
 */

#define PY_SSIZE_T_CLEAN
#include <Python.h>
#include <stdint.h>
#include <string.h>

static int append_long(PyObject *list, long value) {
    PyObject *obj = PyLong_FromLong(value);
    if (!obj) return -1;
    int rc = PyList_Append(list, obj);
    Py_DECREF(obj);
    return rc;
}

static PyObject *
fastpack_pack(PyObject *Py_UNUSED(self), PyObject *args)
{
    PyObject *markets;
    if (!PyArg_ParseTuple(args, "O", &markets))
        return NULL;
    PyObject *markets_fast = PySequence_Fast(markets, "markets must be a sequence");
    if (!markets_fast) return NULL;

    PyObject *pair_market = PyList_New(0);
    PyObject *pair_source_ids = PyList_New(0);
    PyObject *flat_probs = PyList_New(0);
    PyObject *flat_pair = PyList_New(0);
    PyObject *signals_per_market = PyList_New(0);
    PyObject *pair_offsets = PyList_New(0);
    PyObject *by_source = NULL, *slot_of = NULL, *ordered = NULL;
    PyObject *key_source = NULL, *key_prob = NULL;

    if (!pair_market || !pair_source_ids || !flat_probs || !flat_pair ||
        !signals_per_market || !pair_offsets)
        goto fail;

    key_source = PyUnicode_InternFromString("sourceId");
    key_prob = PyUnicode_InternFromString("probability");
    if (!key_source || !key_prob) goto fail;

    if (append_long(pair_offsets, 0) < 0) goto fail;

    Py_ssize_t num_markets = PySequence_Fast_GET_SIZE(markets_fast);
    for (Py_ssize_t m = 0; m < num_markets; m++) {
        PyObject *entry = PySequence_Fast_GET_ITEM(markets_fast, m);  /* borrowed */
        if (!PyTuple_Check(entry) && !PyList_Check(entry)) {
            PyErr_SetString(PyExc_TypeError, "each market must be (id, signals)");
            goto fail;
        }
        PyObject *signals = PySequence_GetItem(entry, 1);  /* new ref */
        if (!signals) goto fail;
        PyObject *signals_fast = PySequence_Fast(signals, "signals must be a sequence");
        Py_DECREF(signals);
        if (!signals_fast) goto fail;

        Py_ssize_t num_signals = PySequence_Fast_GET_SIZE(signals_fast);
        if (append_long(signals_per_market, (long)num_signals) < 0) {
            Py_DECREF(signals_fast); goto fail;
        }

        /* Group: source id → first-seen order (value unused; dict preserves
         * insertion order, we only need the key set). */
        by_source = PyDict_New();
        if (!by_source) { Py_DECREF(signals_fast); goto fail; }
        for (Py_ssize_t s = 0; s < num_signals; s++) {
            PyObject *signal = PySequence_Fast_GET_ITEM(signals_fast, s);
            PyObject *sid = PyObject_GetItem(signal, key_source);  /* new */
            if (!sid) { Py_DECREF(signals_fast); goto fail; }
            if (PyDict_SetItem(by_source, sid, Py_None) < 0) {
                Py_DECREF(sid); Py_DECREF(signals_fast); goto fail;
            }
            Py_DECREF(sid);
        }

        /* Sorted unique source ids → slot assignment. */
        ordered = PyDict_Keys(by_source);
        if (!ordered || PyList_Sort(ordered) < 0) { Py_DECREF(signals_fast); goto fail; }

        Py_ssize_t base = PyList_GET_SIZE(pair_source_ids);
        slot_of = PyDict_New();
        if (!slot_of) { Py_DECREF(signals_fast); goto fail; }
        Py_ssize_t num_unique = PyList_GET_SIZE(ordered);
        for (Py_ssize_t u = 0; u < num_unique; u++) {
            PyObject *sid = PyList_GET_ITEM(ordered, u);  /* borrowed */
            PyObject *slot = PyLong_FromSsize_t(base + u);
            if (!slot || PyDict_SetItem(slot_of, sid, slot) < 0) {
                Py_XDECREF(slot); Py_DECREF(signals_fast); goto fail;
            }
            Py_DECREF(slot);
            if (append_long(pair_market, (long)m) < 0 ||
                PyList_Append(pair_source_ids, sid) < 0) {
                Py_DECREF(signals_fast); goto fail;
            }
        }

        /* Flat emission in original signal order (preserves the scalar
         * engine's duplicate-averaging float order). */
        for (Py_ssize_t s = 0; s < num_signals; s++) {
            PyObject *signal = PySequence_Fast_GET_ITEM(signals_fast, s);
            PyObject *sid = PyObject_GetItem(signal, key_source);
            if (!sid) { Py_DECREF(signals_fast); goto fail; }
            PyObject *slot = PyDict_GetItem(slot_of, sid);  /* borrowed */
            Py_DECREF(sid);
            if (!slot) {
                PyErr_SetString(PyExc_RuntimeError, "slot lookup failed");
                Py_DECREF(signals_fast); goto fail;
            }
            PyObject *prob = PyObject_GetItem(signal, key_prob);
            if (!prob) { Py_DECREF(signals_fast); goto fail; }
            if (PyList_Append(flat_probs, prob) < 0 ||
                PyList_Append(flat_pair, slot) < 0) {
                Py_DECREF(prob); Py_DECREF(signals_fast); goto fail;
            }
            Py_DECREF(prob);
        }

        if (append_long(pair_offsets, (long)PyList_GET_SIZE(pair_source_ids)) < 0) {
            Py_DECREF(signals_fast); goto fail;
        }
        Py_DECREF(signals_fast);
        Py_CLEAR(by_source);
        Py_CLEAR(ordered);
        Py_CLEAR(slot_of);
    }

    Py_DECREF(markets_fast);
    Py_XDECREF(key_source);
    Py_XDECREF(key_prob);
    return Py_BuildValue(
        "(NNNNNN)",
        pair_market, pair_source_ids, flat_probs, flat_pair,
        signals_per_market, pair_offsets);

fail:
    Py_XDECREF(markets_fast);
    Py_XDECREF(pair_market);
    Py_XDECREF(pair_source_ids);
    Py_XDECREF(flat_probs);
    Py_XDECREF(flat_pair);
    Py_XDECREF(signals_per_market);
    Py_XDECREF(pair_offsets);
    Py_XDECREF(by_source);
    Py_XDECREF(ordered);
    Py_XDECREF(slot_of);
    Py_XDECREF(key_source);
    Py_XDECREF(key_prob);
    return NULL;
}

/* ---- columnar fast path -------------------------------------------------- */

static int
int32_cmp(const void *pa, const void *pb)
{
    int32_t a = *(const int32_t *)pa, b = *(const int32_t *)pb;
    return (a > b) - (a < b);
}

/* Contiguous buffer helper: fills *view, validating element width.
 * writable=1 requests a writable buffer. Returns element count or -1. */
static Py_ssize_t
get_elems(PyObject *obj, Py_buffer *view, int itemsize, int writable,
          const char *name)
{
    int flags = writable ? (PyBUF_CONTIG) : (PyBUF_CONTIG_RO);
    if (PyObject_GetBuffer(obj, view, flags) < 0) return -1;
    if (view->len % itemsize != 0) {
        PyErr_Format(PyExc_ValueError,
                     "%s: buffer length %zd is not a multiple of %d",
                     name, view->len, itemsize);
        PyBuffer_Release(view);
        view->obj = NULL;
        return -1;
    }
    return view->len / itemsize;
}

/* group_columns: the whole-column grouping pass. Inputs are per-signal
 * int32 source codes, the code → sorted-rank permutation (int32[U]),
 * CSR int64 offsets (M+1), and float64 probabilities. Outputs land in
 * preallocated buffers: signal→pair (int64[N]), pair market / rank
 * (int32, capacity >= P), pair offsets (int64[M+1]), per-pair sums
 * (float64) and counts (int64). Returns the pair count P.
 *
 * Equivalence notes (pinned by tests/test_torch_native.py):
 *  - pairs emit market-major with ranks ascending within each market —
 *    exactly np.unique's sorted (market * stride + rank) key order;
 *  - per-pair sums accumulate in original signal order — np.add.at's
 *    sequential-accumulate semantics, so duplicate averaging keeps the
 *    scalar engine's left-to-right float order bit-for-bit. */
static PyObject *
fastpack_group_columns(PyObject *Py_UNUSED(self), PyObject *args)
{
    PyObject *codes_o, *rank_o, *offs_o, *probs_o;
    PyObject *sp_o, *pm_o, *pr_o, *po_o, *sums_o, *cnt_o;
    if (!PyArg_ParseTuple(args, "OOOOOOOOOO", &codes_o, &rank_o, &offs_o,
                          &probs_o, &sp_o, &pm_o, &pr_o, &po_o, &sums_o,
                          &cnt_o))
        return NULL;

    Py_buffer codes = {0}, rank = {0}, offs = {0}, probs = {0};
    Py_buffer sp = {0}, pm = {0}, pr = {0}, po = {0}, sums = {0}, cnt = {0};
    int64_t *stamp = NULL, *slot = NULL;
    int32_t *market_ranks = NULL;
    PyObject *result = NULL;

    Py_ssize_t n = get_elems(codes_o, &codes, 4, 0, "codes");
    Py_ssize_t u = n < 0 ? -1 : get_elems(rank_o, &rank, 4, 0, "rank_of_code");
    Py_ssize_t mo = u < 0 ? -1 : get_elems(offs_o, &offs, 8, 0, "offsets");
    Py_ssize_t np_ = mo < 0 ? -1 : get_elems(probs_o, &probs, 8, 0, "probs");
    Py_ssize_t nsp = np_ < 0 ? -1 : get_elems(sp_o, &sp, 8, 1, "out_signal_pair");
    Py_ssize_t npm = nsp < 0 ? -1 : get_elems(pm_o, &pm, 4, 1, "out_pair_market");
    Py_ssize_t npr = npm < 0 ? -1 : get_elems(pr_o, &pr, 4, 1, "out_pair_rank");
    Py_ssize_t npo = npr < 0 ? -1 : get_elems(po_o, &po, 8, 1, "out_pair_offsets");
    Py_ssize_t nsums = npo < 0 ? -1 : get_elems(sums_o, &sums, 8, 1, "out_sums");
    Py_ssize_t ncnt = nsums < 0 ? -1 : get_elems(cnt_o, &cnt, 8, 1, "out_counts");
    if (ncnt < 0) goto done;

    Py_ssize_t m = mo - 1;
    if (m < 0 || np_ != n || nsp != n || npo != mo) {
        PyErr_SetString(PyExc_ValueError,
                        "group_columns: inconsistent buffer shapes");
        goto done;
    }
    Py_ssize_t cap = npm;
    if (npr < cap) cap = npr;
    if (nsums < cap) cap = nsums;
    if (ncnt < cap) cap = ncnt;

    const int32_t *codes_p = (const int32_t *)codes.buf;
    const int32_t *rank_p = (const int32_t *)rank.buf;
    const int64_t *offs_p = (const int64_t *)offs.buf;
    const double *probs_p = (const double *)probs.buf;
    int64_t *sp_p = (int64_t *)sp.buf;
    int32_t *pm_p = (int32_t *)pm.buf;
    int32_t *pr_p = (int32_t *)pr.buf;
    int64_t *po_p = (int64_t *)po.buf;
    double *sums_p = (double *)sums.buf;
    int64_t *cnt_p = (int64_t *)cnt.buf;

    int64_t max_width = 0;
    for (Py_ssize_t i = 0; i < m; i++) {
        int64_t w = offs_p[i + 1] - offs_p[i];
        if (offs_p[i] < 0 || w < 0 || offs_p[i + 1] > n) {
            PyErr_SetString(PyExc_ValueError,
                            "group_columns: offsets out of range");
            goto done;
        }
        if (w > max_width) max_width = w;
    }
    if (m > 0 && offs_p[0] != 0) {
        PyErr_SetString(PyExc_ValueError,
                        "group_columns: offsets must start at 0");
        goto done;
    }
    /* The terminal offset must cover every signal: a short CSR would
     * silently drop the tail AND leave out_signal_pair's tail
     * uninitialized (the numpy twin errors on the same input). */
    if ((m > 0 ? offs_p[m] : 0) != n) {
        PyErr_Format(PyExc_ValueError,
                     "group_columns: offsets cover %lld signals but "
                     "codes/probs carry %zd",
                     (long long)(m > 0 ? offs_p[m] : 0), n);
        goto done;
    }

    stamp = PyMem_Malloc((size_t)(u ? u : 1) * 8);
    slot = PyMem_Malloc((size_t)(u ? u : 1) * 8);
    market_ranks = PyMem_Malloc((size_t)(max_width ? max_width : 1) * 4);
    if (!stamp || !slot || !market_ranks) {
        PyErr_NoMemory();
        goto done;
    }
    memset(stamp, 0xFF, (size_t)(u ? u : 1) * 8); /* int64 -1 fill */

    int64_t pair_base = 0;
    po_p[0] = 0;
    for (Py_ssize_t mk = 0; mk < m; mk++) {
        int64_t lo = offs_p[mk], hi = offs_p[mk + 1];
        int64_t uniq = 0;
        for (int64_t s = lo; s < hi; s++) {
            int32_t c = codes_p[s];
            if (c < 0 || c >= u) {
                PyErr_Format(PyExc_IndexError,
                             "signal %lld: code %d out of table range",
                             (long long)s, c);
                goto done;
            }
            int32_t r = rank_p[c];
            if (r < 0 || r >= u) {
                PyErr_Format(PyExc_IndexError,
                             "code %d: rank %d out of range", c, r);
                goto done;
            }
            if (stamp[r] != (int64_t)mk) {
                stamp[r] = (int64_t)mk;
                market_ranks[uniq++] = r;
            }
        }
        qsort(market_ranks, (size_t)uniq, sizeof(int32_t), int32_cmp);
        if (pair_base + uniq > cap) {
            PyErr_SetString(PyExc_ValueError,
                            "group_columns: pair output buffers too small");
            goto done;
        }
        for (int64_t j = 0; j < uniq; j++) {
            int32_t r = market_ranks[j];
            int64_t p = pair_base + j;
            slot[r] = p;
            pm_p[p] = (int32_t)mk;
            pr_p[p] = r;
            sums_p[p] = 0.0;
            cnt_p[p] = 0;
        }
        for (int64_t s = lo; s < hi; s++) {
            int64_t p = slot[rank_p[codes_p[s]]];
            sp_p[s] = p;
            sums_p[p] += probs_p[s];
            cnt_p[p] += 1;
        }
        pair_base += uniq;
        po_p[mk + 1] = pair_base;
    }
    result = PyLong_FromLongLong((long long)pair_base);

done:
    PyMem_Free(stamp);
    PyMem_Free(slot);
    PyMem_Free(market_ranks);
    if (codes.obj) PyBuffer_Release(&codes);
    if (rank.obj) PyBuffer_Release(&rank);
    if (offs.obj) PyBuffer_Release(&offs);
    if (probs.obj) PyBuffer_Release(&probs);
    if (sp.obj) PyBuffer_Release(&sp);
    if (pm.obj) PyBuffer_Release(&pm);
    if (pr.obj) PyBuffer_Release(&pr);
    if (po.obj) PyBuffer_Release(&po);
    if (sums.obj) PyBuffer_Release(&sums);
    if (cnt.obj) PyBuffer_Release(&cnt);
    return result;
}

/* pair_accumulate(pair_idx, probs, out_sums): out_sums[idx[i]] += probs[i]
 * in signal order (np.add.at's sequential accumulate — the refresh twin's
 * float-summation contract). pair_idx may be int32 or int64; out_sums
 * must arrive zeroed by the caller. */
static PyObject *
fastpack_pair_accumulate(PyObject *Py_UNUSED(self), PyObject *args)
{
    PyObject *idx_o, *probs_o, *sums_o;
    if (!PyArg_ParseTuple(args, "OOO", &idx_o, &probs_o, &sums_o))
        return NULL;
    Py_buffer idx = {0}, probs = {0}, sums = {0};
    PyObject *result = NULL;

    if (PyObject_GetBuffer(idx_o, &idx, PyBUF_CONTIG_RO) < 0) goto done;
    Py_ssize_t n = get_elems(probs_o, &probs, 8, 0, "probs");
    Py_ssize_t p_cap = n < 0 ? -1 : get_elems(sums_o, &sums, 8, 1, "out_sums");
    if (p_cap < 0) goto done;

    const double *probs_p = (const double *)probs.buf;
    double *sums_p = (double *)sums.buf;
    if (idx.len == n * 8) {
        const int64_t *idx_p = (const int64_t *)idx.buf;
        for (Py_ssize_t i = 0; i < n; i++) {
            int64_t p = idx_p[i];
            if (p < 0 || p >= p_cap) {
                PyErr_Format(PyExc_IndexError,
                             "pair index %lld out of range", (long long)p);
                goto done;
            }
            sums_p[p] += probs_p[i];
        }
    } else if (idx.len == n * 4) {
        const int32_t *idx_p = (const int32_t *)idx.buf;
        for (Py_ssize_t i = 0; i < n; i++) {
            int32_t p = idx_p[i];
            if (p < 0 || p >= p_cap) {
                PyErr_Format(PyExc_IndexError,
                             "pair index %d out of range", p);
                goto done;
            }
            sums_p[p] += probs_p[i];
        }
    } else {
        PyErr_SetString(PyExc_ValueError,
                        "pair_idx must be int32 or int64, one per prob");
        goto done;
    }
    result = Py_None;
    Py_INCREF(result);

done:
    if (idx.obj) PyBuffer_Release(&idx);
    if (probs.obj) PyBuffer_Release(&probs);
    if (sums.obj) PyBuffer_Release(&sums);
    return result;
}

/* columns_from_payloads(payloads) ->
 *     (market_keys, source_ids, probs_bytearray, offsets_bytearray)
 * One C pass flattening dict payloads to the columnar layout: probs are
 * float64 host bytes, offsets int64 (M+1) — both wrap as numpy arrays
 * with no copy. Identical values to the pure-Python loop (probability
 * conversion goes through the same __float__ protocol numpy uses). */
static PyObject *
fastpack_columns_from_payloads(PyObject *Py_UNUSED(self), PyObject *arg)
{
    PyObject *markets_fast = PySequence_Fast(
        arg, "payloads must be a sequence");
    if (!markets_fast) return NULL;
    Py_ssize_t m = PySequence_Fast_GET_SIZE(markets_fast);

    PyObject *keys = PyList_New(0);
    PyObject *sids = PyList_New(0);
    PyObject *offs_ba = PyByteArray_FromStringAndSize(NULL, (m + 1) * 8);
    PyObject *key_source = PyUnicode_InternFromString("sourceId");
    PyObject *key_prob = PyUnicode_InternFromString("probability");
    double *probs_buf = NULL;
    size_t probs_used = 0, probs_cap = 1024;
    probs_buf = PyMem_Malloc(probs_cap * sizeof(double));
    if (!keys || !sids || !offs_ba || !key_source || !key_prob ||
        !probs_buf) {
        if (!probs_buf) PyErr_NoMemory();
        goto fail;
    }
    int64_t *offs = (int64_t *)PyByteArray_AS_STRING(offs_ba);
    offs[0] = 0;

    for (Py_ssize_t i = 0; i < m; i++) {
        PyObject *entry = PySequence_Fast_GET_ITEM(markets_fast, i);
        if (!PyTuple_Check(entry) && !PyList_Check(entry)) {
            PyErr_SetString(PyExc_TypeError,
                            "each payload must be (market_id, signals)");
            goto fail;
        }
        PyObject *market_id = PySequence_GetItem(entry, 0);
        if (!market_id) goto fail;
        int rc = PyList_Append(keys, market_id);
        Py_DECREF(market_id);
        if (rc < 0) goto fail;
        PyObject *signals = PySequence_GetItem(entry, 1);
        if (!signals) goto fail;
        PyObject *signals_fast = PySequence_Fast(
            signals, "signals must be a sequence");
        Py_DECREF(signals);
        if (!signals_fast) goto fail;
        Py_ssize_t ns = PySequence_Fast_GET_SIZE(signals_fast);
        if (probs_used + (size_t)ns > probs_cap) {
            size_t cap = probs_cap * 2;
            while (probs_used + (size_t)ns > cap) cap *= 2;
            double *grown = PyMem_Realloc(probs_buf, cap * sizeof(double));
            if (!grown) {
                PyErr_NoMemory();
                Py_DECREF(signals_fast);
                goto fail;
            }
            probs_buf = grown;
            probs_cap = cap;
        }
        for (Py_ssize_t s = 0; s < ns; s++) {
            PyObject *signal = PySequence_Fast_GET_ITEM(signals_fast, s);
            PyObject *sid = PyObject_GetItem(signal, key_source);
            if (!sid) { Py_DECREF(signals_fast); goto fail; }
            rc = PyList_Append(sids, sid);
            Py_DECREF(sid);
            if (rc < 0) { Py_DECREF(signals_fast); goto fail; }
            PyObject *prob = PyObject_GetItem(signal, key_prob);
            if (!prob) { Py_DECREF(signals_fast); goto fail; }
            double value = PyFloat_AsDouble(prob);
            Py_DECREF(prob);
            if (value == -1.0 && PyErr_Occurred()) {
                Py_DECREF(signals_fast);
                goto fail;
            }
            probs_buf[probs_used++] = value;
        }
        Py_DECREF(signals_fast);
        offs[i + 1] = (int64_t)probs_used;
    }

    PyObject *probs_ba = PyByteArray_FromStringAndSize(
        (const char *)probs_buf, (Py_ssize_t)(probs_used * sizeof(double)));
    PyMem_Free(probs_buf);
    probs_buf = NULL;
    if (!probs_ba) goto fail;
    Py_DECREF(markets_fast);
    Py_DECREF(key_source);
    Py_DECREF(key_prob);
    return Py_BuildValue("(NNNN)", keys, sids, probs_ba, offs_ba);

fail:
    PyMem_Free(probs_buf);
    Py_XDECREF(markets_fast);
    Py_XDECREF(keys);
    Py_XDECREF(sids);
    Py_XDECREF(offs_ba);
    Py_XDECREF(key_source);
    Py_XDECREF(key_prob);
    return NULL;
}

/* join_codes(codes, table) -> bytes: UTF-8 of table[code] per signal,
 * concatenated — equal to "".join(table[c] for c in codes).encode()
 * (UTF-8 of a concatenation is the concatenation of UTF-8), the joined
 * half of topology_fingerprint's source column for the coded intake. */
static PyObject *
fastpack_join_codes(PyObject *Py_UNUSED(self), PyObject *args)
{
    PyObject *codes_o, *table_o;
    if (!PyArg_ParseTuple(args, "OO", &codes_o, &table_o)) return NULL;
    PyObject *table = PySequence_Fast(table_o, "table must be a sequence");
    if (!table) return NULL;
    Py_ssize_t u = PySequence_Fast_GET_SIZE(table);

    Py_buffer codes = {0};
    typedef struct { const char *buf; Py_ssize_t len; } strview_t;
    strview_t *views = NULL;
    PyObject *out = NULL;

    Py_ssize_t n = get_elems(codes_o, &codes, 4, 0, "codes");
    if (n < 0) goto done;
    views = PyMem_Calloc((size_t)(u ? u : 1), sizeof(strview_t));
    if (!views) {
        PyErr_NoMemory();
        goto done;
    }
    const int32_t *codes_p = (const int32_t *)codes.buf;
    size_t total = 0;
    for (Py_ssize_t i = 0; i < n; i++) {
        int32_t c = codes_p[i];
        if (c < 0 || c >= u) {
            PyErr_Format(PyExc_IndexError,
                         "signal %zd: code %d out of table range", i, c);
            goto done;
        }
        if (!views[c].buf) {
            PyObject *item = PySequence_Fast_GET_ITEM(table, c);
            if (!PyUnicode_Check(item)) {
                PyErr_SetString(PyExc_TypeError, "table entries must be str");
                goto done;
            }
            views[c].buf = PyUnicode_AsUTF8AndSize(item, &views[c].len);
            if (!views[c].buf) goto done;
        }
        total += (size_t)views[c].len;
    }
    out = PyBytes_FromStringAndSize(NULL, (Py_ssize_t)total);
    if (!out) goto done;
    char *dst = PyBytes_AS_STRING(out);
    for (Py_ssize_t i = 0; i < n; i++) {
        strview_t *v = &views[codes_p[i]];
        memcpy(dst, v->buf, (size_t)v->len);
        dst += v->len;
    }

done:
    PyMem_Free(views);
    if (codes.obj) PyBuffer_Release(&codes);
    Py_DECREF(table);
    return out;
}

static PyMethodDef fastpack_methods[] = {
    {"pack", fastpack_pack, METH_VARARGS,
     "pack(markets) -> (pair_market, pair_source_ids, flat_probs, flat_pair, "
     "signals_per_market, pair_offsets)"},
    {"group_columns", fastpack_group_columns, METH_VARARGS,
     "group_columns(codes, rank_of_code, offsets, probs, out_signal_pair, "
     "out_pair_market, out_pair_rank, out_pair_offsets, out_sums, "
     "out_counts) -> num_pairs"},
    {"pair_accumulate", fastpack_pair_accumulate, METH_VARARGS,
     "pair_accumulate(pair_idx, probs, out_sums): ordered per-pair sum"},
    {"columns_from_payloads", fastpack_columns_from_payloads, METH_O,
     "columns_from_payloads(payloads) -> (market_keys, source_ids, "
     "probs_bytearray, offsets_bytearray)"},
    {"join_codes", fastpack_join_codes, METH_VARARGS,
     "join_codes(codes, table) -> concatenated UTF-8 bytes"},
    {NULL, NULL, 0, NULL},
};

static struct PyModuleDef fastpack_module = {
    PyModuleDef_HEAD_INIT,
    "fastpack",
    "Native signal-ingest packer (C twin of core.batch.pack_markets grouping).",
    -1,
    fastpack_methods,
};

PyMODINIT_FUNC
PyInit_fastpack(void)
{
    return PyModule_Create(&fastpack_module);
}
