/* internmap — native id-interning hash for bayesian_consensus_engine_tpu_torch.
 *
 * The TPU state tensors are keyed by dense int32 rows; ids — source ids and
 * (source_id, market_id) pairs — are interned to rows at the host boundary
 * (utils/interning.py, state/tensor_store.py). At ingest scale (millions of
 * pairs per settlement batch) the pure-Python dict loop pays per-item
 * bytecode dispatch, tuple construction, and PyLong boxing; this module
 * provides batch interning in one C pass over an open-addressing FNV-1a
 * table, returning a ready-to-upload int32 buffer (wrap with
 * numpy.frombuffer, no copies).
 *
 * Design notes (why inserts are pure C):
 *   - key bytes live in one growable arena (offset-addressed, so realloc
 *     is safe); no per-key malloc.
 *   - no Python objects are created at insert time: the id for a row is
 *     materialised lazily by ids()/id_of() from the arena bytes (a pair is
 *     recognised by its embedded NUL separator — see key spaces below).
 *   - batch calls pre-size the table for the incoming run, so a cold 1M-pair
 *     batch does not pay incremental rehashes.
 *
 * Contract: row assignment is first-seen order, identical to the Python
 * IdInterner (equivalence enforced by tests/test_torch_native.py). Pair keys
 * are the two UTF-8 strings joined by a NUL byte; to keep the single-key
 * and pair-key spaces disjoint, NUL is rejected in EVERY key half AND in
 * single-string keys (so intern("a\0b") cannot alias intern_pair("a","b")).
 * The reference caps ids at 256 chars and its validator rejects empty ids
 * (reference: config.py:37-38), so real ids never hit the restriction.
 *
 * API (all methods on InternMap):
 *   intern(str) -> int                      single string key
 *   intern_pair(str, str) -> int           single pair key
 *   intern_batch(seq[str]) -> bytearray            int32 rows, len*4 bytes
 *   intern_pairs(seq[str], seq[str]) -> bytearray  elementwise pair keys
 *   lookup(str) -> int        (-1 when absent; no insertion)
 *   lookup_pair(str, str) -> int
 *   lookup_pairs(seq[str], seq[str]) -> bytearray  (-1 rows when absent)
 *   __len__() -> unique keys; ids() -> list (row order; str or (str, str))
 *   sorted_rows(buffer[i32]) -> bytearray  rows reordered by key bytes
 *   flush_sqlite(path, rows, rel, conf, iso) -> int   checkpoint writer
 *
 * The last two back the SQLite checkpoint fast path
 * (state/tensor_store.flush_to_sqlite): sorting rows by raw key bytes
 * reproduces Python's (source_id, market_id) tuple sort exactly — the NUL
 * separator orders below every valid id byte and UTF-8 byte order equals
 * code-point order — and the writer binds arena bytes straight into a
 * dlopen()ed libsqlite3, so a million-row flush never materialises a
 * Python string, tuple, or number. Without libsqlite3 the writer raises
 * and the caller falls back to the sqlite3-module path.
 */

#define PY_SSIZE_T_CLEAN
#include <Python.h>
#include <stdint.h>
#include <string.h>
#ifndef _WIN32
#include <dlfcn.h>
#endif

typedef struct {
    uint64_t hash;     /* 0 means empty (FNV-1a output is remapped off 0) */
    int32_t row;
    uint32_t key_len;
    size_t key_off;    /* offset of the key bytes in the arena */
} slot_t;

typedef struct {
    size_t off;
    uint32_t len;
} rowref_t;

typedef struct {
    PyObject_HEAD
    slot_t *slots;
    size_t capacity;   /* power of two */
    size_t used;
    char *arena;       /* all key bytes, back to back */
    size_t arena_used;
    size_t arena_cap;
    rowref_t *rows;    /* row -> key bytes, for lazy id materialisation */
    size_t rows_cap;
} InternMap;

static uint64_t
fnv1a(const char *data, size_t len)
{
    uint64_t h = 1469598103934665603ULL;
    for (size_t i = 0; i < len; i++) {
        h ^= (unsigned char)data[i];
        h *= 1099511628211ULL;
    }
    return h ? h : 1ULL;  /* reserve 0 for "empty slot" */
}

static int
map_resize(InternMap *self, size_t new_capacity)
{
    slot_t *fresh = PyMem_Calloc(new_capacity, sizeof(slot_t));
    if (!fresh) {
        PyErr_NoMemory();
        return -1;
    }
    size_t mask = new_capacity - 1;
    for (size_t i = 0; i < self->capacity; i++) {
        slot_t *old = &self->slots[i];
        if (!old->hash) continue;
        size_t j = old->hash & mask;
        while (fresh[j].hash) j = (j + 1) & mask;
        fresh[j] = *old;
    }
    PyMem_Free(self->slots);
    self->slots = fresh;
    self->capacity = new_capacity;
    return 0;
}

/* Pre-size the table for an incoming batch of *n* keys, but only when the
 * map holds far fewer keys than the batch — i.e. most of the batch is
 * probably new (a cold load). A warm batch (most keys already present)
 * must NOT trigger this: treating its n as all-new would resize the table
 * 2x past need on every call, paying a full rehash and colder probes. */
static int
map_reserve_cold(InternMap *self, size_t n)
{
    if (self->used * 8 >= n) return 0;
    size_t cap = self->capacity;
    while (n * 3 >= cap * 2) cap *= 2;
    if (cap == self->capacity) return 0;
    return map_resize(self, cap);
}

/* Append the key at the already-located EMPTY slot *i*; returns the new
 * row or -1 on error. The probe that found slot *i* is the caller's job
 * (map_intern_hashed's walk, or commit_probed resuming from a recorded
 * probe-phase slot). */
static int32_t
map_insert_at(InternMap *self, size_t i, const char *key, size_t len,
              uint64_t h)
{
    if (self->used >= (size_t)INT32_MAX) {
        PyErr_SetString(PyExc_OverflowError, "more than 2^31-1 interned ids");
        return -1;
    }
    if (self->arena_used + len > self->arena_cap) {
        size_t cap = self->arena_cap * 2;
        while (self->arena_used + len > cap) cap *= 2;
        char *grown = PyMem_Realloc(self->arena, cap);
        if (!grown) {
            PyErr_NoMemory();
            return -1;
        }
        self->arena = grown;
        self->arena_cap = cap;
    }
    if (self->used >= self->rows_cap) {
        size_t cap = self->rows_cap * 2;
        rowref_t *grown = PyMem_Realloc(self->rows, cap * sizeof(rowref_t));
        if (!grown) {
            PyErr_NoMemory();
            return -1;
        }
        self->rows = grown;
        self->rows_cap = cap;
    }
    size_t off = self->arena_used;
    memcpy(self->arena + off, key, len);
    self->arena_used += len;

    int32_t row = (int32_t)self->used;
    self->rows[row].off = off;
    self->rows[row].len = (uint32_t)len;
    self->slots[i].hash = h;
    self->slots[i].row = row;
    self->slots[i].key_len = (uint32_t)len;
    self->slots[i].key_off = off;
    self->used++;
    return row;
}

/* Find or insert the key; returns the row, or -1 on error. */
static int32_t
map_intern_hashed(InternMap *self, const char *key, size_t len, uint64_t h)
{
    if (self->used * 3 >= self->capacity * 2) {
        if (map_resize(self, self->capacity * 2) < 0) return -1;
    }
    size_t mask = self->capacity - 1;
    size_t i = h & mask;
    while (self->slots[i].hash) {
        slot_t *s = &self->slots[i];
        if (s->hash == h && s->key_len == len &&
            memcmp(self->arena + s->key_off, key, len) == 0)
            return s->row;
        i = (i + 1) & mask;
    }
    return map_insert_at(self, i, key, len, h);
}

static int32_t
map_intern(InternMap *self, const char *key, size_t len)
{
    return map_intern_hashed(self, key, len, fnv1a(key, len));
}

/* Prefetch hint for the batched insert pipeline (no-op off GCC/clang). */
#if defined(__GNUC__) || defined(__clang__)
#define FF_PREFETCH(p) __builtin_prefetch((p), 0, 1)
#else
#define FF_PREFETCH(p) ((void)0)
#endif

static int32_t
map_lookup(InternMap *self, const char *key, size_t len)
{
    uint64_t h = fnv1a(key, len);
    size_t mask = self->capacity - 1;
    size_t i = h & mask;
    while (self->slots[i].hash) {
        slot_t *s = &self->slots[i];
        if (s->hash == h && s->key_len == len &&
            memcmp(self->arena + s->key_off, key, len) == 0)
            return s->row;
        i = (i + 1) & mask;
    }
    return -1;
}

/* Build the Python id object for a row from its arena bytes: a NUL byte
 * marks a pair key (singles reject NUL), so "a\0b" -> ("a", "b"). */
static PyObject *
row_to_id(InternMap *self, size_t row)
{
    const char *key = self->arena + self->rows[row].off;
    size_t len = self->rows[row].len;
    const char *sep = memchr(key, '\0', len);
    if (!sep)
        return PyUnicode_DecodeUTF8(key, (Py_ssize_t)len, NULL);
    Py_ssize_t alen = sep - key;
    PyObject *a = PyUnicode_DecodeUTF8(key, alen, NULL);
    if (!a) return NULL;
    PyObject *b = PyUnicode_DecodeUTF8(sep + 1, (Py_ssize_t)len - alen - 1, NULL);
    if (!b) {
        Py_DECREF(a);
        return NULL;
    }
    PyObject *pair = PyTuple_Pack(2, a, b);
    Py_DECREF(a);
    Py_DECREF(b);
    return pair;
}

/* ---- key building -------------------------------------------------------- */

/* UTF-8 view of a str; sets error and returns NULL on non-str. */
static const char *
utf8_of(PyObject *obj, Py_ssize_t *len)
{
    if (!PyUnicode_Check(obj)) {
        PyErr_Format(PyExc_TypeError, "expected str, got %.100s",
                     Py_TYPE(obj)->tp_name);
        return NULL;
    }
    return PyUnicode_AsUTF8AndSize(obj, len);
}

/* NUL would let a single-string key alias a NUL-joined pair key; reject it
 * in both key kinds so the two key spaces cannot collide. */
static int
reject_nul(const char *buf, Py_ssize_t len)
{
    if (memchr(buf, '\0', (size_t)len)) {
        PyErr_SetString(PyExc_ValueError, "ids must not contain NUL");
        return -1;
    }
    return 0;
}

/* Joined "a\0b" key in *scratch (grown as needed). Returns length or -1. */
static Py_ssize_t
pair_key(PyObject *a, PyObject *b, char **scratch, Py_ssize_t *scratch_cap)
{
    Py_ssize_t alen, blen;
    const char *abuf = utf8_of(a, &alen);
    if (!abuf) return -1;
    const char *bbuf = utf8_of(b, &blen);
    if (!bbuf) return -1;
    if (reject_nul(abuf, alen) < 0 || reject_nul(bbuf, blen) < 0) return -1;
    Py_ssize_t need = alen + 1 + blen;
    if (need > *scratch_cap) {
        char *grown = PyMem_Realloc(*scratch, (size_t)(need * 2));
        if (!grown) {
            PyErr_NoMemory();
            return -1;
        }
        *scratch = grown;
        *scratch_cap = need * 2;
    }
    memcpy(*scratch, abuf, (size_t)alen);
    (*scratch)[alen] = '\0';
    memcpy(*scratch + alen + 1, bbuf, (size_t)blen);
    return need;
}

/* Validated fast views of two equal-length sequences. Returns 0 or -1. */
static int
two_seqs(PyObject *args, PyObject **fast_a, PyObject **fast_b, Py_ssize_t *n)
{
    PyObject *seq_a, *seq_b;
    if (!PyArg_ParseTuple(args, "OO", &seq_a, &seq_b)) return -1;
    *fast_a = PySequence_Fast(seq_a, "expected a sequence of str");
    if (!*fast_a) return -1;
    *fast_b = PySequence_Fast(seq_b, "expected a sequence of str");
    if (!*fast_b) {
        Py_DECREF(*fast_a);
        return -1;
    }
    *n = PySequence_Fast_GET_SIZE(*fast_a);
    if (PySequence_Fast_GET_SIZE(*fast_b) != *n) {
        PyErr_SetString(PyExc_ValueError, "sequences must have equal length");
        Py_DECREF(*fast_a);
        Py_DECREF(*fast_b);
        return -1;
    }
    return 0;
}

/* ---- methods ------------------------------------------------------------- */

static PyObject *
InternMap_intern(InternMap *self, PyObject *arg)
{
    Py_ssize_t len;
    const char *buf = utf8_of(arg, &len);
    if (!buf) return NULL;
    if (reject_nul(buf, len) < 0) return NULL;
    int32_t row = map_intern(self, buf, (size_t)len);
    if (row < 0) return NULL;
    return PyLong_FromLong(row);
}

static PyObject *
InternMap_intern_pair(InternMap *self, PyObject *args)
{
    PyObject *a, *b;
    if (!PyArg_ParseTuple(args, "OO", &a, &b)) return NULL;
    char *scratch = NULL;
    Py_ssize_t cap = 0;
    Py_ssize_t len = pair_key(a, b, &scratch, &cap);
    if (len < 0) {
        PyMem_Free(scratch);
        return NULL;
    }
    int32_t row = map_intern(self, scratch, (size_t)len);
    PyMem_Free(scratch);
    if (row < 0) return NULL;
    return PyLong_FromLong(row);
}

static PyObject *
InternMap_intern_batch(InternMap *self, PyObject *arg)
{
    PyObject *fast = PySequence_Fast(arg, "expected a sequence of str");
    if (!fast) return NULL;
    Py_ssize_t n = PySequence_Fast_GET_SIZE(fast);
    PyObject *out = PyByteArray_FromStringAndSize(NULL, n * 4);
    if (!out || map_reserve_cold(self, (size_t)n) < 0) {
        Py_XDECREF(out);
        Py_DECREF(fast);
        return NULL;
    }
    int32_t *rows = (int32_t *)PyByteArray_AS_STRING(out);
    for (Py_ssize_t i = 0; i < n; i++) {
        PyObject *item = PySequence_Fast_GET_ITEM(fast, i);
        Py_ssize_t len;
        const char *buf = utf8_of(item, &len);
        if (!buf) goto fail;
        if (reject_nul(buf, len) < 0) goto fail;
        int32_t row = map_intern(self, buf, (size_t)len);
        if (row < 0) goto fail;
        rows[i] = row;
    }
    Py_DECREF(fast);
    return out;
fail:
    Py_DECREF(fast);
    Py_DECREF(out);
    return NULL;
}

static PyObject *
InternMap_intern_pairs(InternMap *self, PyObject *args)
{
    PyObject *fast_a, *fast_b;
    Py_ssize_t n;
    if (two_seqs(args, &fast_a, &fast_b, &n) < 0) return NULL;
    PyObject *out = PyByteArray_FromStringAndSize(NULL, n * 4);
    char *scratch = NULL;
    /* Same chunked assemble→hash→prefetch→insert pipeline as the indexed
     * path (see intern_pairs_indexed): the inserts are random-miss-bound
     * on the slots table at scale, and prefetching each key's home slot
     * while the rest of the chunk assembles hides part of the latency.
     * Error-recovery parity preserved: pairs before a failing pair still
     * intern before the error raises. */
    enum { FF_PCHUNK = 1024 };
    size_t offs[FF_PCHUNK];
    uint32_t lens[FF_PCHUNK];
    uint64_t hashes[FF_PCHUNK];
    Py_ssize_t cap = 64 * FF_PCHUNK;
    scratch = PyMem_Malloc((size_t)cap);
    if (!out || !scratch || map_reserve_cold(self, (size_t)n) < 0) {
        if (!scratch) PyErr_NoMemory();
        goto fail;
    }
    int32_t *rows = (int32_t *)PyByteArray_AS_STRING(out);
    for (Py_ssize_t start = 0; start < n; start += FF_PCHUNK) {
        Py_ssize_t m = n - start < FF_PCHUNK ? n - start : FF_PCHUNK;
        size_t kused = 0;
        int chunk_failed = 0;
        Py_ssize_t assembled = m;
        for (Py_ssize_t j = 0; j < m; j++) {
            PyObject *a = PySequence_Fast_GET_ITEM(fast_a, start + j);
            PyObject *b = PySequence_Fast_GET_ITEM(fast_b, start + j);
            Py_ssize_t alen, blen;
            const char *abuf = utf8_of(a, &alen);
            const char *bbuf = abuf ? utf8_of(b, &blen) : NULL;
            if (!abuf || !bbuf || reject_nul(abuf, alen) < 0 ||
                reject_nul(bbuf, blen) < 0) {
                chunk_failed = 1;
                assembled = j;
                break;
            }
            Py_ssize_t need = alen + 1 + blen;
            if ((Py_ssize_t)kused + need > cap) {
                cap = ((Py_ssize_t)kused + need) * 2;
                char *grown = PyMem_Realloc(scratch, (size_t)cap);
                if (!grown) {
                    PyErr_NoMemory();
                    chunk_failed = 1;
                    assembled = j;
                    break;
                }
                scratch = grown;
            }
            memcpy(scratch + kused, abuf, (size_t)alen);
            scratch[kused + (size_t)alen] = '\0';
            memcpy(scratch + kused + (size_t)alen + 1, bbuf, (size_t)blen);
            offs[j] = kused;
            lens[j] = (uint32_t)need;
            hashes[j] = fnv1a(scratch + kused, (size_t)need);
            FF_PREFETCH(&self->slots[hashes[j] & (self->capacity - 1)]);
            kused += (size_t)need;
        }
        for (Py_ssize_t j = 0; j < assembled; j++) {
            int32_t row = map_intern_hashed(
                self, scratch + offs[j], lens[j], hashes[j]);
            if (row < 0) goto fail;
            rows[start + j] = row;
        }
        if (chunk_failed) goto fail;
    }
    PyMem_Free(scratch);
    Py_DECREF(fast_a);
    Py_DECREF(fast_b);
    return out;
fail:
    PyMem_Free(scratch);
    Py_XDECREF(out);
    Py_DECREF(fast_a);
    Py_DECREF(fast_b);
    return NULL;
}

/* intern_pairs_indexed(a_table, a_codes, b_table, b_codes) -> bytearray.
 *
 * Elementwise pair interning where each half is given as (unique string
 * table, int32 code buffer) instead of one Python string per element: the
 * UTF-8 views are resolved once per TABLE entry, so a million-pair batch
 * whose ids repeat heavily (the settlement planner's shape — ~10k sources,
 * unique-but-tabled markets) skips per-element PyUnicode traffic entirely.
 * Code buffers must be contiguous int32 of equal element count; codes
 * index their table (range-checked).
 */
static PyObject *
InternMap_intern_pairs_indexed(InternMap *self, PyObject *args)
{
    PyObject *a_table_obj, *b_table_obj, *a_codes_obj, *b_codes_obj;
    if (!PyArg_ParseTuple(args, "OOOO", &a_table_obj, &a_codes_obj,
                          &b_table_obj, &b_codes_obj))
        return NULL;

    typedef struct { const char *buf; Py_ssize_t len; } strview_t;
    PyObject *fast_a = NULL, *fast_b = NULL, *out = NULL;
    strview_t *views_a = NULL, *views_b = NULL;
    char *scratch = NULL;
    Py_buffer codes_a, codes_b;
    codes_a.obj = NULL;
    codes_b.obj = NULL;

    fast_a = PySequence_Fast(a_table_obj, "expected a sequence of str");
    if (!fast_a) goto fail;
    fast_b = PySequence_Fast(b_table_obj, "expected a sequence of str");
    if (!fast_b) goto fail;
    if (PyObject_GetBuffer(a_codes_obj, &codes_a, PyBUF_CONTIG_RO) < 0)
        goto fail;
    if (PyObject_GetBuffer(b_codes_obj, &codes_b, PyBUF_CONTIG_RO) < 0)
        goto fail;
    if (codes_a.len != codes_b.len || codes_a.len % 4 != 0) {
        PyErr_SetString(PyExc_ValueError,
                        "code buffers must be equal-length int32");
        goto fail;
    }
    Py_ssize_t n = codes_a.len / 4;
    Py_ssize_t na = PySequence_Fast_GET_SIZE(fast_a);
    Py_ssize_t nb = PySequence_Fast_GET_SIZE(fast_b);

    /* UTF-8 views resolve LAZILY, on a table entry's first use (cached on
     * the str objects, which the caller's tables keep alive for the whole
     * call): an entry no code references — e.g. a zero-signal market's
     * id — is never validated, exactly like the per-pair paths it
     * replaces. buf == NULL marks "not yet resolved". */
    views_a = PyMem_Calloc((size_t)(na ? na : 1), sizeof(strview_t));
    views_b = PyMem_Calloc((size_t)(nb ? nb : 1), sizeof(strview_t));
    if (!views_a || !views_b) {
        PyErr_NoMemory();
        goto fail;
    }

    out = PyByteArray_FromStringAndSize(NULL, n * 4);
    if (!out || map_reserve_cold(self, (size_t)n) < 0) goto fail;
    /* Chunked assemble→hash→prefetch→insert pipeline. The insert is
     * DRAM/TLB-latency-bound (every probe is a random miss into a table
     * of hundreds of MB at million-pair scale); assembling a chunk of
     * keys first and prefetching each key's home slot while the rest of
     * the chunk assembles hides part of that latency (alternating A/B on
     * the 4M-pair cold-ingest fixture: ~30% off this pass, ~12-15% off
     * whole-plan columnar ingest). 1024 keys × 64 B of prefetched slot
     * lines stays well inside L2. */
    enum { FF_CHUNK = 1024 };
    size_t offs[FF_CHUNK];
    uint32_t lens[FF_CHUNK];
    uint64_t hashes[FF_CHUNK];
    Py_ssize_t scratch_cap = 64 * FF_CHUNK;
    scratch = PyMem_Malloc((size_t)scratch_cap);
    if (!scratch) {
        PyErr_NoMemory();
        goto fail;
    }
    const int32_t *ca = (const int32_t *)codes_a.buf;
    const int32_t *cb = (const int32_t *)codes_b.buf;
    int32_t *rows = (int32_t *)PyByteArray_AS_STRING(out);
    for (Py_ssize_t start = 0; start < n; start += FF_CHUNK) {
        Py_ssize_t m = n - start < FF_CHUNK ? n - start : FF_CHUNK;
        size_t kused = 0;
        /* A validation failure at pair j must still intern pairs
         * [start, start+j) first: the per-pair paths (and the Python
         * IdInterner) intern everything before the bad pair, and a caller
         * that catches the error observes that state — the chunking is an
         * implementation detail and may not change it. */
        int chunk_failed = 0;
        Py_ssize_t assembled = m;
        for (Py_ssize_t j = 0; j < m; j++) {
            Py_ssize_t i = start + j;
            int32_t ia = ca[i], ib = cb[i];
            if (ia < 0 || ia >= na || ib < 0 || ib >= nb) {
                PyErr_Format(PyExc_IndexError,
                             "pair %zd: code (%d, %d) out of table range",
                             i, ia, ib);
                chunk_failed = 1;
                assembled = j;
                break;
            }
            if (!views_a[ia].buf) {
                views_a[ia].buf = utf8_of(
                    PySequence_Fast_GET_ITEM(fast_a, ia), &views_a[ia].len);
                if (!views_a[ia].buf ||
                    reject_nul(views_a[ia].buf, views_a[ia].len) < 0) {
                    chunk_failed = 1;
                    assembled = j;
                    break;
                }
            }
            if (!views_b[ib].buf) {
                views_b[ib].buf = utf8_of(
                    PySequence_Fast_GET_ITEM(fast_b, ib), &views_b[ib].len);
                if (!views_b[ib].buf ||
                    reject_nul(views_b[ib].buf, views_b[ib].len) < 0) {
                    chunk_failed = 1;
                    assembled = j;
                    break;
                }
            }
            Py_ssize_t alen = views_a[ia].len, blen = views_b[ib].len;
            Py_ssize_t need = alen + 1 + blen;
            if ((Py_ssize_t)kused + need > scratch_cap) {
                scratch_cap = ((Py_ssize_t)kused + need) * 2;
                char *grown = PyMem_Realloc(scratch, (size_t)scratch_cap);
                if (!grown) {
                    PyErr_NoMemory();
                    chunk_failed = 1;
                    assembled = j;
                    break;
                }
                scratch = grown;
            }
            memcpy(scratch + kused, views_a[ia].buf, (size_t)alen);
            scratch[kused + (size_t)alen] = '\0';
            memcpy(scratch + kused + (size_t)alen + 1, views_b[ib].buf,
                   (size_t)blen);
            offs[j] = kused;
            lens[j] = (uint32_t)need;
            hashes[j] = fnv1a(scratch + kused, (size_t)need);
            FF_PREFETCH(&self->slots[hashes[j] & (self->capacity - 1)]);
            kused += (size_t)need;
        }
        for (Py_ssize_t j = 0; j < assembled; j++) {
            int32_t row = map_intern_hashed(
                self, scratch + offs[j], lens[j], hashes[j]);
            if (row < 0) goto fail;  /* insert error outranks a later one */
            rows[start + j] = row;
        }
        if (chunk_failed) goto fail;
    }
    PyMem_Free(scratch);
    PyMem_Free(views_a);
    PyMem_Free(views_b);
    PyBuffer_Release(&codes_a);
    PyBuffer_Release(&codes_b);
    Py_DECREF(fast_a);
    Py_DECREF(fast_b);
    return out;

fail:
    PyMem_Free(scratch);
    PyMem_Free(views_a);
    PyMem_Free(views_b);
    if (codes_a.obj) PyBuffer_Release(&codes_a);
    if (codes_b.obj) PyBuffer_Release(&codes_b);
    Py_XDECREF(fast_a);
    Py_XDECREF(fast_b);
    Py_XDECREF(out);
    return NULL;
}

/* ---- delta interning: batch probe + deterministic commit ----------------- */

typedef struct { const char *buf; Py_ssize_t len; } ff_view_t;

/* Resolve every table entry's UTF-8 view up front (GIL held, cached on
 * the str objects the caller's table keeps alive) so a probe loop can
 * run with the GIL released. NUL-rejects every entry — the probe
 * validates the whole table, unlike the lazy per-use resolution of the
 * insert paths. *max_len gets the longest entry. Returns NULL on error. */
static ff_view_t *
resolve_table_views(PyObject *fast, Py_ssize_t n, Py_ssize_t *max_len)
{
    ff_view_t *views = PyMem_Malloc((size_t)(n ? n : 1) * sizeof(ff_view_t));
    if (!views) {
        PyErr_NoMemory();
        return NULL;
    }
    for (Py_ssize_t i = 0; i < n; i++) {
        views[i].buf = utf8_of(PySequence_Fast_GET_ITEM(fast, i),
                               &views[i].len);
        if (!views[i].buf || reject_nul(views[i].buf, views[i].len) < 0) {
            PyMem_Free(views);
            return NULL;
        }
        if (views[i].len > *max_len) *max_len = views[i].len;
    }
    return views;
}

/* probe_pairs_indexed(a_table, a_codes, b_table, b_codes,
 *                     rows_out, hashes_out, slots_out, start, stop)
 *     -> miss count in [start, stop)
 *
 * The batch-probe half of the delta interning pass (round 15): for every
 * pair in [start, stop) — (unique table, int32 codes) halves exactly as
 * intern_pairs_indexed takes them — LOOK UP the joined key without
 * inserting, writing into caller-preallocated full-batch-length buffers
 *
 *   rows_out[i]   int32  the existing row, or -1 when absent
 *   hashes_out[i] uint64 the key's hash (valid for every probed i)
 *   slots_out[i]  int64  the first EMPTY slot on the key's probe chain —
 *                        the insertion point commit_probed resumes from
 *                        (only meaningful where rows_out[i] < 0)
 *
 * The main loop runs with the GIL RELEASED (table views are resolved up
 * front and the map is only read), so worker threads probing disjoint
 * [start, stop) ranges of one batch truly overlap — the sharded intern
 * pass in utils/interning.py. The map must not be mutated between a
 * probe and its commit (the tensor store's host lock guarantees that);
 * commit_probed re-verifies the capacity it was probed against.
 */
static PyObject *
InternMap_probe_pairs_indexed(InternMap *self, PyObject *args)
{
    PyObject *a_table_obj, *b_table_obj, *a_codes_obj, *b_codes_obj;
    PyObject *rows_obj, *hashes_obj, *slots_obj;
    Py_ssize_t start, stop;
    if (!PyArg_ParseTuple(args, "OOOOOOOnn", &a_table_obj, &a_codes_obj,
                          &b_table_obj, &b_codes_obj, &rows_obj,
                          &hashes_obj, &slots_obj, &start, &stop))
        return NULL;

    PyObject *fast_a = NULL, *fast_b = NULL;
    ff_view_t *views_a = NULL, *views_b = NULL;
    char *scratch = NULL;
    Py_buffer codes_a, codes_b, rows_v, hashes_v, slots_v;
    codes_a.obj = codes_b.obj = rows_v.obj = hashes_v.obj = slots_v.obj =
        NULL;

    fast_a = PySequence_Fast(a_table_obj, "expected a sequence of str");
    if (!fast_a) goto fail;
    fast_b = PySequence_Fast(b_table_obj, "expected a sequence of str");
    if (!fast_b) goto fail;
    if (PyObject_GetBuffer(a_codes_obj, &codes_a, PyBUF_CONTIG_RO) < 0 ||
        PyObject_GetBuffer(b_codes_obj, &codes_b, PyBUF_CONTIG_RO) < 0 ||
        PyObject_GetBuffer(rows_obj, &rows_v, PyBUF_CONTIG) < 0 ||
        PyObject_GetBuffer(hashes_obj, &hashes_v, PyBUF_CONTIG) < 0 ||
        PyObject_GetBuffer(slots_obj, &slots_v, PyBUF_CONTIG) < 0)
        goto fail;
    if (codes_a.len != codes_b.len || codes_a.len % 4 != 0 ||
        rows_v.len != codes_a.len || hashes_v.len != codes_a.len * 2 ||
        slots_v.len != codes_a.len * 2) {
        PyErr_SetString(PyExc_ValueError,
                        "buffers must be equal-count int32 codes/rows with "
                        "uint64 hashes and int64 slots");
        goto fail;
    }
    Py_ssize_t n = codes_a.len / 4;
    if (start < 0 || stop < start || stop > n) {
        PyErr_SetString(PyExc_IndexError, "probe range out of bounds");
        goto fail;
    }
    Py_ssize_t na = PySequence_Fast_GET_SIZE(fast_a);
    Py_ssize_t nb = PySequence_Fast_GET_SIZE(fast_b);
    Py_ssize_t max_a = 0, max_b = 0;
    views_a = resolve_table_views(fast_a, na, &max_a);
    if (!views_a) goto fail;
    views_b = resolve_table_views(fast_b, nb, &max_b);
    if (!views_b) goto fail;
    /* Same chunked assemble→hash→prefetch→lookup pipeline as the insert
     * paths: the lookups are random-miss-bound on the slots table, and
     * prefetching each key's home slot while the rest of the chunk
     * assembles hides part of the latency (the probe is the phase the
     * sharded pass parallelises, so its per-pair cost IS the floor). */
    enum { FF_QCHUNK = 1024 };
    Py_ssize_t max_key = max_a + 1 + max_b + 1;
    scratch = PyMem_Malloc((size_t)(FF_QCHUNK * max_key));
    if (!scratch) {
        PyErr_NoMemory();
        goto fail;
    }

    const int32_t *ca = (const int32_t *)codes_a.buf;
    const int32_t *cb = (const int32_t *)codes_b.buf;
    int32_t *rows = (int32_t *)rows_v.buf;
    uint64_t *hashes = (uint64_t *)hashes_v.buf;
    int64_t *slot_out = (int64_t *)slots_v.buf;
    Py_ssize_t misses = 0;
    Py_ssize_t bad_index = -1;
    Py_BEGIN_ALLOW_THREADS
    size_t mask = self->capacity - 1;
    size_t offs[FF_QCHUNK];
    uint32_t lens[FF_QCHUNK];
    for (Py_ssize_t cstart = start; cstart < stop && bad_index < 0;
         cstart += FF_QCHUNK) {
        Py_ssize_t m = stop - cstart < FF_QCHUNK ? stop - cstart
                                                 : FF_QCHUNK;
        size_t kused = 0;
        Py_ssize_t assembled = m;
        for (Py_ssize_t j = 0; j < m; j++) {
            Py_ssize_t i = cstart + j;
            int32_t ia = ca[i], ib = cb[i];
            if (ia < 0 || ia >= na || ib < 0 || ib >= nb) {
                bad_index = i;
                assembled = j;
                break;
            }
            size_t alen = (size_t)views_a[ia].len;
            size_t blen = (size_t)views_b[ib].len;
            size_t len = alen + 1 + blen;
            memcpy(scratch + kused, views_a[ia].buf, alen);
            scratch[kused + alen] = '\0';
            memcpy(scratch + kused + alen + 1, views_b[ib].buf, blen);
            offs[j] = kused;
            lens[j] = (uint32_t)len;
            uint64_t h = fnv1a(scratch + kused, len);
            hashes[i] = h;
            FF_PREFETCH(&self->slots[h & mask]);
            kused += len;
        }
        for (Py_ssize_t j = 0; j < assembled; j++) {
            Py_ssize_t i = cstart + j;
            const char *key = scratch + offs[j];
            size_t len = lens[j];
            uint64_t h = hashes[i];
            size_t k = h & mask;
            int32_t row = -1;
            while (self->slots[k].hash) {
                slot_t *s = &self->slots[k];
                if (s->hash == h && s->key_len == len &&
                    memcmp(self->arena + s->key_off, key, len) == 0) {
                    row = s->row;
                    break;
                }
                k = (k + 1) & mask;
            }
            rows[i] = row;
            if (row < 0) {
                slot_out[i] = (int64_t)k;  /* the first empty slot found */
                misses++;
            } else {
                slot_out[i] = -1;
            }
        }
    }
    Py_END_ALLOW_THREADS
    if (bad_index >= 0) {
        PyErr_Format(PyExc_IndexError,
                     "pair %zd: code (%d, %d) out of table range",
                     bad_index, (int)ca[bad_index], (int)cb[bad_index]);
        goto fail;
    }

    PyMem_Free(scratch);
    PyMem_Free(views_a);
    PyMem_Free(views_b);
    PyBuffer_Release(&codes_a);
    PyBuffer_Release(&codes_b);
    PyBuffer_Release(&rows_v);
    PyBuffer_Release(&hashes_v);
    PyBuffer_Release(&slots_v);
    Py_DECREF(fast_a);
    Py_DECREF(fast_b);
    return PyLong_FromSsize_t(misses);

fail:
    PyMem_Free(scratch);
    PyMem_Free(views_a);
    PyMem_Free(views_b);
    if (codes_a.obj) PyBuffer_Release(&codes_a);
    if (codes_b.obj) PyBuffer_Release(&codes_b);
    if (rows_v.obj) PyBuffer_Release(&rows_v);
    if (hashes_v.obj) PyBuffer_Release(&hashes_v);
    if (slots_v.obj) PyBuffer_Release(&slots_v);
    Py_XDECREF(fast_a);
    Py_XDECREF(fast_b);
    return NULL;
}

/* commit_probed(a_table, a_codes, b_table, b_codes, rows, hashes, slots,
 *               probed_capacity) -> newly probed-in (miss) count committed
 *
 * The deterministic serial half of the sharded intern pass: walk the
 * batch IN INDEX ORDER and intern exactly the pairs the probe phase left
 * at rows[i] < 0, writing each assigned row back into rows[i] in place.
 * Row assignment is therefore first-occurrence-in-batch order —
 * identical, key for key, to one intern_pairs_indexed pass over the
 * whole batch (existing pairs never allocate in either path), which is
 * the byte-parity contract the delta-interning path rests on.
 *
 * probed_capacity is the slots-table capacity the probe ran against:
 * while it still holds (no resize since), each insert RESUMES from the
 * recorded first-empty slot — the hash and the walk to the insertion
 * point were already paid in the (parallel) probe phase, so the commit
 * does no full-chain re-probe. Equality is still checked from the
 * resumed slot (keys inserted since the probe live at or past it), so
 * duplicate keys in one batch commit to one row. The first internal
 * resize — or a capacity mismatch at entry, i.e. the map was mutated
 * between probe and commit — falls back to standard hash-based probing
 * for the remaining keys; results are identical either way.
 */
static PyObject *
InternMap_commit_probed(InternMap *self, PyObject *args)
{
    PyObject *a_table_obj, *b_table_obj, *a_codes_obj, *b_codes_obj;
    PyObject *rows_obj, *hashes_obj, *slots_obj;
    Py_ssize_t probed_capacity;
    if (!PyArg_ParseTuple(args, "OOOOOOOn", &a_table_obj, &a_codes_obj,
                          &b_table_obj, &b_codes_obj, &rows_obj,
                          &hashes_obj, &slots_obj, &probed_capacity))
        return NULL;

    PyObject *fast_a = NULL, *fast_b = NULL;
    ff_view_t *views_a = NULL, *views_b = NULL;
    char *scratch = NULL;
    Py_ssize_t scratch_cap = 0;
    Py_buffer codes_a, codes_b, rows_v, hashes_v, slots_v;
    codes_a.obj = codes_b.obj = rows_v.obj = hashes_v.obj = slots_v.obj =
        NULL;

    fast_a = PySequence_Fast(a_table_obj, "expected a sequence of str");
    if (!fast_a) goto fail;
    fast_b = PySequence_Fast(b_table_obj, "expected a sequence of str");
    if (!fast_b) goto fail;
    if (PyObject_GetBuffer(a_codes_obj, &codes_a, PyBUF_CONTIG_RO) < 0 ||
        PyObject_GetBuffer(b_codes_obj, &codes_b, PyBUF_CONTIG_RO) < 0 ||
        PyObject_GetBuffer(rows_obj, &rows_v, PyBUF_CONTIG) < 0 ||
        PyObject_GetBuffer(hashes_obj, &hashes_v, PyBUF_CONTIG_RO) < 0 ||
        PyObject_GetBuffer(slots_obj, &slots_v, PyBUF_CONTIG_RO) < 0)
        goto fail;
    if (codes_a.len != codes_b.len || codes_a.len % 4 != 0 ||
        rows_v.len != codes_a.len || hashes_v.len != codes_a.len * 2 ||
        slots_v.len != codes_a.len * 2) {
        PyErr_SetString(PyExc_ValueError,
                        "buffers must be equal-count int32 codes/rows with "
                        "uint64 hashes and int64 slots");
        goto fail;
    }
    Py_ssize_t n = codes_a.len / 4;
    Py_ssize_t na = PySequence_Fast_GET_SIZE(fast_a);
    Py_ssize_t nb = PySequence_Fast_GET_SIZE(fast_b);

    /* Lazy views, like intern_pairs_indexed: only entries a MISS
     * references resolve (hits never re-assemble their key). */
    views_a = PyMem_Calloc((size_t)(na ? na : 1), sizeof(ff_view_t));
    views_b = PyMem_Calloc((size_t)(nb ? nb : 1), sizeof(ff_view_t));
    if (!views_a || !views_b) {
        PyErr_NoMemory();
        goto fail;
    }
    scratch_cap = 256;
    scratch = PyMem_Malloc((size_t)scratch_cap);
    if (!scratch) {
        PyErr_NoMemory();
        goto fail;
    }

    const int32_t *ca = (const int32_t *)codes_a.buf;
    const int32_t *cb = (const int32_t *)codes_b.buf;
    int32_t *rows = (int32_t *)rows_v.buf;
    const uint64_t *hashes = (const uint64_t *)hashes_v.buf;
    const int64_t *slot_in = (const int64_t *)slots_v.buf;
    int use_slots = (size_t)probed_capacity == self->capacity;
    Py_ssize_t committed = 0;
    for (Py_ssize_t i = 0; i < n; i++) {
        if (rows[i] >= 0) continue;
        if (use_slots && i + 24 < n && rows[i + 24] < 0) {
            /* Look-ahead prefetch of an upcoming miss's recorded slot —
             * the insert's one random access. */
            int64_t ahead = slot_in[i + 24];
            if ((size_t)ahead < self->capacity)
                FF_PREFETCH(&self->slots[ahead]);
        }
        int32_t ia = ca[i], ib = cb[i];
        if (ia < 0 || ia >= na || ib < 0 || ib >= nb) {
            PyErr_Format(PyExc_IndexError,
                         "pair %zd: code (%d, %d) out of table range",
                         i, ia, ib);
            goto fail;
        }
        if (!views_a[ia].buf) {
            views_a[ia].buf = utf8_of(
                PySequence_Fast_GET_ITEM(fast_a, ia), &views_a[ia].len);
            if (!views_a[ia].buf ||
                reject_nul(views_a[ia].buf, views_a[ia].len) < 0)
                goto fail;
        }
        if (!views_b[ib].buf) {
            views_b[ib].buf = utf8_of(
                PySequence_Fast_GET_ITEM(fast_b, ib), &views_b[ib].len);
            if (!views_b[ib].buf ||
                reject_nul(views_b[ib].buf, views_b[ib].len) < 0)
                goto fail;
        }
        Py_ssize_t alen = views_a[ia].len, blen = views_b[ib].len;
        Py_ssize_t need = alen + 1 + blen;
        if (need > scratch_cap) {
            scratch_cap = need * 2;
            char *grown = PyMem_Realloc(scratch, (size_t)scratch_cap);
            if (!grown) {
                PyErr_NoMemory();
                goto fail;
            }
            scratch = grown;
        }
        memcpy(scratch, views_a[ia].buf, (size_t)alen);
        scratch[alen] = '\0';
        memcpy(scratch + alen + 1, views_b[ib].buf, (size_t)blen);
        uint64_t h = hashes[i];
        int32_t row = -1;
        if (use_slots && self->used * 3 >= self->capacity * 2) {
            if (map_resize(self, self->capacity * 2) < 0) goto fail;
            use_slots = 0;  /* recorded slots are stale from here on */
        }
        if (use_slots) {
            size_t mask = self->capacity - 1;
            size_t j = (size_t)slot_in[i];
            if (j >= self->capacity) {
                use_slots = 0;
                row = map_intern_hashed(self, scratch, (size_t)need, h);
            } else {
                while (self->slots[j].hash) {
                    slot_t *s = &self->slots[j];
                    if (s->hash == h && s->key_len == (uint32_t)need &&
                        memcmp(self->arena + s->key_off, scratch,
                               (size_t)need) == 0) {
                        row = s->row;
                        break;
                    }
                    j = (j + 1) & mask;
                }
                if (row < 0)
                    row = map_insert_at(self, j, scratch, (size_t)need, h);
            }
        } else {
            row = map_intern_hashed(self, scratch, (size_t)need, h);
        }
        if (row < 0) goto fail;
        rows[i] = row;
        committed++;
    }

    PyMem_Free(scratch);
    PyMem_Free(views_a);
    PyMem_Free(views_b);
    PyBuffer_Release(&codes_a);
    PyBuffer_Release(&codes_b);
    PyBuffer_Release(&rows_v);
    PyBuffer_Release(&hashes_v);
    PyBuffer_Release(&slots_v);
    Py_DECREF(fast_a);
    Py_DECREF(fast_b);
    return PyLong_FromSsize_t(committed);

fail:
    PyMem_Free(scratch);
    PyMem_Free(views_a);
    PyMem_Free(views_b);
    if (codes_a.obj) PyBuffer_Release(&codes_a);
    if (codes_b.obj) PyBuffer_Release(&codes_b);
    if (rows_v.obj) PyBuffer_Release(&rows_v);
    if (hashes_v.obj) PyBuffer_Release(&hashes_v);
    if (slots_v.obj) PyBuffer_Release(&slots_v);
    Py_XDECREF(fast_a);
    Py_XDECREF(fast_b);
    return NULL;
}

/* reserve_pairs(n) -> capacity token
 *
 * Pre-size the table for an incoming batch of *n* keys (the same
 * cold-load heuristic every batch insert runs) BEFORE a probe pass, so
 * the probe's recorded slots stay valid through the commit. Returns the
 * post-reserve capacity — the token commit_probed verifies.
 */
static PyObject *
InternMap_reserve_pairs(InternMap *self, PyObject *arg)
{
    Py_ssize_t n = PyLong_AsSsize_t(arg);
    if (n == -1 && PyErr_Occurred()) return NULL;
    if (n < 0) {
        PyErr_SetString(PyExc_ValueError, "reserve size must be >= 0");
        return NULL;
    }
    if (map_reserve_cold(self, (size_t)n) < 0) return NULL;
    return PyLong_FromSize_t(self->capacity);
}

static PyObject *
InternMap_lookup(InternMap *self, PyObject *arg)
{
    Py_ssize_t len;
    const char *buf = utf8_of(arg, &len);
    if (!buf) return NULL;
    return PyLong_FromLong(map_lookup(self, buf, (size_t)len));
}

static PyObject *
InternMap_lookup_pair(InternMap *self, PyObject *args)
{
    PyObject *a, *b;
    if (!PyArg_ParseTuple(args, "OO", &a, &b)) return NULL;
    char *scratch = NULL;
    Py_ssize_t cap = 0;
    Py_ssize_t len = pair_key(a, b, &scratch, &cap);
    if (len < 0) {
        PyMem_Free(scratch);
        return NULL;
    }
    long row = map_lookup(self, scratch, (size_t)len);
    PyMem_Free(scratch);
    return PyLong_FromLong(row);
}

static PyObject *
InternMap_lookup_pairs(InternMap *self, PyObject *args)
{
    PyObject *fast_a, *fast_b;
    Py_ssize_t n;
    if (two_seqs(args, &fast_a, &fast_b, &n) < 0) return NULL;
    PyObject *out = PyByteArray_FromStringAndSize(NULL, n * 4);
    char *scratch = NULL;
    Py_ssize_t cap = 0;
    if (!out) goto fail;
    int32_t *rows = (int32_t *)PyByteArray_AS_STRING(out);
    for (Py_ssize_t i = 0; i < n; i++) {
        PyObject *a = PySequence_Fast_GET_ITEM(fast_a, i);
        PyObject *b = PySequence_Fast_GET_ITEM(fast_b, i);
        Py_ssize_t len = pair_key(a, b, &scratch, &cap);
        if (len < 0) goto fail;
        rows[i] = map_lookup(self, scratch, (size_t)len);
    }
    PyMem_Free(scratch);
    Py_DECREF(fast_a);
    Py_DECREF(fast_b);
    return out;
fail:
    PyMem_Free(scratch);
    Py_XDECREF(out);
    Py_DECREF(fast_a);
    Py_DECREF(fast_b);
    return NULL;
}

static PyObject *
InternMap_ids(InternMap *self, PyObject *Py_UNUSED(ignored))
{
    PyObject *out = PyList_New((Py_ssize_t)self->used);
    if (!out) return NULL;
    for (size_t row = 0; row < self->used; row++) {
        PyObject *id_obj = row_to_id(self, row);
        if (!id_obj) {
            Py_DECREF(out);
            return NULL;
        }
        PyList_SET_ITEM(out, (Py_ssize_t)row, id_obj);
    }
    return out;
}

static PyObject *
InternMap_id_of(InternMap *self, PyObject *arg)
{
    Py_ssize_t row = PyLong_AsSsize_t(arg);
    if (row == -1 && PyErr_Occurred()) return NULL;
    if (row < 0 || (size_t)row >= self->used) {
        PyErr_SetString(PyExc_IndexError, "row out of range");
        return NULL;
    }
    return row_to_id(self, (size_t)row);
}

static Py_ssize_t
InternMap_len(InternMap *self)
{
    return (Py_ssize_t)self->used;
}

/* pair_blob(lo, hi) -> bytes
 *
 * Rows [lo, hi) as (u32 src_len, src utf-8, u32 mkt_len, mkt utf-8) —
 * the durability journal's pair wire format (state/journal.py), built
 * at memcpy speed straight from the arena instead of per-row Python
 * struct.pack (measured: the Python loop cost ~seconds per million
 * rows and dominated a journal epoch). Lengths are written in host
 * byte order; the journal format is little-endian, which every
 * platform this builds on is — static-asserted at module init. */
static PyObject *
InternMap_pair_blob(InternMap *self, PyObject *args)
{
    Py_ssize_t lo, hi;
    if (!PyArg_ParseTuple(args, "nn", &lo, &hi)) return NULL;
    if (lo < 0 || hi < lo || (size_t)hi > self->used) {
        PyErr_SetString(PyExc_IndexError, "row range out of bounds");
        return NULL;
    }
    size_t total = 0;
    for (Py_ssize_t row = lo; row < hi; row++) {
        if (self->rows[row].len < 1) {
            PyErr_SetString(PyExc_ValueError, "corrupt arena row");
            return NULL;
        }
        /* two u32 prefixes + key bytes minus the NUL joiner */
        total += 8 + (size_t)self->rows[row].len - 1;
    }
    PyObject *out = PyBytes_FromStringAndSize(NULL, (Py_ssize_t)total);
    if (!out) return NULL;
    char *dst = PyBytes_AS_STRING(out);
    for (Py_ssize_t row = lo; row < hi; row++) {
        const char *key = self->arena + self->rows[row].off;
        uint32_t len = self->rows[row].len;
        const char *nul = memchr(key, '\0', len);
        if (!nul) {
            Py_DECREF(out);
            PyErr_SetString(PyExc_ValueError, "arena key missing joiner");
            return NULL;
        }
        uint32_t src_len = (uint32_t)(nul - key);
        uint32_t mkt_len = len - src_len - 1;
        memcpy(dst, &src_len, 4); dst += 4;
        memcpy(dst, key, src_len); dst += src_len;
        memcpy(dst, &mkt_len, 4); dst += 4;
        memcpy(dst, nul + 1, mkt_len); dst += mkt_len;
    }
    return out;
}

/* pack_strings(list[str]) -> bytes: u32-length-prefixed UTF-8 values —
 * the journal's iso-blob wire format, one C pass instead of per-row
 * struct.pack. */
static PyObject *
internmap_pack_strings(PyObject *Py_UNUSED(module), PyObject *arg)
{
    if (!PyList_Check(arg)) {
        PyErr_SetString(PyExc_TypeError, "pack_strings takes a list of str");
        return NULL;
    }
    Py_ssize_t n = PyList_GET_SIZE(arg);
    size_t total = 0;
    for (Py_ssize_t i = 0; i < n; i++) {
        Py_ssize_t len;
        /* Cached on the unicode object; the second pass reuses it. */
        if (!PyUnicode_AsUTF8AndSize(PyList_GET_ITEM(arg, i), &len))
            return NULL;
        total += 4 + (size_t)len;
    }
    PyObject *out = PyBytes_FromStringAndSize(NULL, (Py_ssize_t)total);
    if (!out) return NULL;
    char *dst = PyBytes_AS_STRING(out);
    for (Py_ssize_t i = 0; i < n; i++) {
        Py_ssize_t len;
        const char *buf =
            PyUnicode_AsUTF8AndSize(PyList_GET_ITEM(arg, i), &len);
        if (!buf) {
            Py_DECREF(out);
            return NULL;
        }
        uint32_t le_len = (uint32_t)len;
        memcpy(dst, &le_len, 4); dst += 4;
        memcpy(dst, buf, (size_t)len); dst += len;
    }
    return out;
}

/* ---- key-order sort ------------------------------------------------------ */

/* memcmp over the raw arena keys == Python's (source, market) tuple sort:
 * the NUL joiner sorts below every valid id byte (ids reject NUL), and
 * UTF-8 byte order equals Unicode code-point order.
 *
 * The comparator context travels through a file-static pointer instead of
 * qsort_r (whose signature differs between glibc and BSD/macOS); the GIL
 * is held across the qsort call, so the static cannot be raced. */
static const InternMap *sort_ctx;

static int
key_bytes_cmp(const void *pa, const void *pb)
{
    const InternMap *self = sort_ctx;
    const rowref_t *ra = &self->rows[*(const int32_t *)pa];
    const rowref_t *rb = &self->rows[*(const int32_t *)pb];
    size_t min_len = ra->len < rb->len ? ra->len : rb->len;
    int cmp = memcmp(self->arena + ra->off, self->arena + rb->off, min_len);
    if (cmp) return cmp;
    return (ra->len > rb->len) - (ra->len < rb->len);
}

/* sorted_rows(buffer[i32]) -> bytearray[i32]: the given rows reordered by
 * their key bytes. Rows must be valid (0 <= row < len(self)). */
static PyObject *
InternMap_sorted_rows(InternMap *self, PyObject *arg)
{
    Py_buffer view;
    if (PyObject_GetBuffer(arg, &view, PyBUF_CONTIG_RO) < 0) return NULL;
    if (view.len % 4 != 0) {
        PyBuffer_Release(&view);
        PyErr_SetString(PyExc_ValueError,
                        "rows buffer length must be a multiple of 4 (int32)");
        return NULL;
    }
    Py_ssize_t n = view.len / 4;
    PyObject *out = PyByteArray_FromStringAndSize(view.buf, view.len);
    PyBuffer_Release(&view);
    if (!out) return NULL;
    int32_t *rows = (int32_t *)PyByteArray_AS_STRING(out);
    for (Py_ssize_t i = 0; i < n; i++) {
        if (rows[i] < 0 || (size_t)rows[i] >= self->used) {
            Py_DECREF(out);
            PyErr_Format(PyExc_IndexError, "row %d out of range", rows[i]);
            return NULL;
        }
    }
    sort_ctx = self;
    qsort(rows, (size_t)n, sizeof(int32_t), key_bytes_cmp);
    return out;
}

/* ---- SQLite checkpoint writer -------------------------------------------- */

/* Hand-declared slice of the stable sqlite3 C ABI, resolved from the
 * runtime library with dlopen: this image ships libsqlite3.so.0 but no
 * development header, and the checkpoint writer needs only these twelve
 * entry points. */
typedef struct sqlite3 sqlite3;
typedef struct sqlite3_stmt sqlite3_stmt;

#define FF_SQLITE_OK 0
#define FF_SQLITE_ROW 100
#define FF_SQLITE_DONE 101
#define FF_SQLITE_OPEN_READWRITE 0x2
#define FF_SQLITE_OPEN_CREATE 0x4
#define FF_SQLITE_STATIC ((void (*)(void *))0)

static struct {
    int loaded; /* 0 = not tried, 1 = ok, -1 = unavailable */
    int (*open_v2)(const char *, sqlite3 **, int, const char *);
    int (*close)(sqlite3 *);
    int (*exec)(sqlite3 *, const char *,
                int (*)(void *, int, char **, char **), void *, char **);
    void (*free)(void *);
    int (*prepare_v2)(sqlite3 *, const char *, int, sqlite3_stmt **,
                      const char **);
    int (*bind_text)(sqlite3_stmt *, int, const char *, int,
                     void (*)(void *));
    int (*bind_double)(sqlite3_stmt *, int, double);
    int (*step)(sqlite3_stmt *);
    int (*reset)(sqlite3_stmt *);
    int (*finalize)(sqlite3_stmt *);
    int (*column_int)(sqlite3_stmt *, int);
    const char *(*errmsg)(sqlite3 *);
    int (*busy_timeout)(sqlite3 *, int);
} ff_sql;

static int
sqlite_runtime_load(void)
{
    if (ff_sql.loaded) return ff_sql.loaded;
#ifdef _WIN32
    ff_sql.loaded = -1;
    return -1;
#else
    /* RTLD_LOCAL: every entry point is dlsym-resolved, and exporting the
     * symbols process-wide could interpose on another extension's own
     * sqlite build. */
    void *lib = dlopen("libsqlite3.so.0", RTLD_NOW | RTLD_LOCAL);
    if (!lib) lib = dlopen("libsqlite3.so", RTLD_NOW | RTLD_LOCAL);
    if (!lib) lib = dlopen("libsqlite3.dylib", RTLD_NOW | RTLD_LOCAL);
    if (!lib) {
        ff_sql.loaded = -1;
        return -1;
    }
#define FF_RESOLVE(field, symbol)                                   \
    do {                                                            \
        *(void **)(&ff_sql.field) = dlsym(lib, symbol);             \
        if (!ff_sql.field) {                                        \
            ff_sql.loaded = -1;                                     \
            return -1;                                              \
        }                                                           \
    } while (0)
    FF_RESOLVE(open_v2, "sqlite3_open_v2");
    FF_RESOLVE(close, "sqlite3_close");
    FF_RESOLVE(exec, "sqlite3_exec");
    FF_RESOLVE(free, "sqlite3_free");
    FF_RESOLVE(prepare_v2, "sqlite3_prepare_v2");
    FF_RESOLVE(bind_text, "sqlite3_bind_text");
    FF_RESOLVE(bind_double, "sqlite3_bind_double");
    FF_RESOLVE(step, "sqlite3_step");
    FF_RESOLVE(reset, "sqlite3_reset");
    FF_RESOLVE(finalize, "sqlite3_finalize");
    FF_RESOLVE(column_int, "sqlite3_column_int");
    FF_RESOLVE(errmsg, "sqlite3_errmsg");
    FF_RESOLVE(busy_timeout, "sqlite3_busy_timeout");
#undef FF_RESOLVE
    ff_sql.loaded = 1;
    return 1;
#endif
}

static const char FF_SCHEMA_SQL[] =
    "CREATE TABLE IF NOT EXISTS sources ("
    " source_id   TEXT    NOT NULL,"
    " market_id   TEXT    NOT NULL,"
    " reliability REAL    NOT NULL DEFAULT 0.5,"
    " confidence  REAL    NOT NULL DEFAULT 0.5,"
    " updated_at  TEXT    NOT NULL,"
    " PRIMARY KEY (source_id, market_id) )"; /* trailing space matches the
       whitespace-normalized sqlite_store._SCHEMA_SQL text exactly (pinned
       by TestNativeFlushParity's sqlite_master comparison) */

static const char FF_UPSERT_SQL[] =
    "INSERT INTO sources"
    " (source_id, market_id, reliability, confidence, updated_at)"
    " VALUES (?, ?, ?, ?, ?)"
    " ON CONFLICT(source_id, market_id)"
    " DO UPDATE SET reliability = excluded.reliability,"
    "               confidence  = excluded.confidence,"
    "               updated_at  = excluded.updated_at";

static const char FF_INSERT_SQL[] =
    "INSERT OR REPLACE INTO sources"
    " (source_id, market_id, reliability, confidence, updated_at)"
    " VALUES (?, ?, ?, ?, ?)";

/* Set a RuntimeError from the connection's message and clean up. */
static void
sqlite_fail(sqlite3 *db, sqlite3_stmt *stmt, const char *doing)
{
    PyErr_Format(PyExc_RuntimeError, "sqlite checkpoint (%s): %s", doing,
                 db ? ff_sql.errmsg(db) : "library unavailable");
    if (stmt) ff_sql.finalize(stmt);
    if (db) {
        ff_sql.exec(db, "ROLLBACK", NULL, NULL, NULL);
        ff_sql.close(db);
    }
}

/* flush_sqlite(path, rows, rel, conf, iso) -> written row count.
 *
 * rows: contiguous int32 buffer of this map's pair-key rows, in the exact
 * order they should hit the file (pre-sort with sorted_rows for the
 * deterministic checkpoint order). rel/conf: contiguous float64 buffers
 * indexed BY ROW (full store columns). iso: list of str indexed by row.
 *
 * Matches the sqlite3-module path byte-for-byte in observable semantics:
 * same WAL journal, same schema, empty-table INSERT fast path, UPSERT
 * otherwise, one transaction. The GIL is held throughout: bindings point
 * into the arena with SQLITE_STATIC lifetimes, and a concurrent intern
 * could realloc the arena out from under them (the store is
 * single-writer by contract; holding the GIL turns that contract into a
 * guarantee here).
 */
static PyObject *
InternMap_flush_sqlite(InternMap *self, PyObject *args)
{
    const char *path;
    PyObject *rows_obj, *rel_obj, *conf_obj, *iso_obj;
    if (!PyArg_ParseTuple(args, "sOOOO", &path, &rows_obj, &rel_obj,
                          &conf_obj, &iso_obj))
        return NULL;
    if (sqlite_runtime_load() < 0) {
        PyErr_SetString(PyExc_RuntimeError,
                        "libsqlite3 runtime library not available");
        return NULL;
    }
    if (!PyList_Check(iso_obj)) {
        PyErr_SetString(PyExc_TypeError, "iso must be a list of str");
        return NULL;
    }

    Py_buffer rows_view, rel_view, conf_view;
    if (PyObject_GetBuffer(rows_obj, &rows_view, PyBUF_CONTIG_RO) < 0)
        return NULL;
    if (PyObject_GetBuffer(rel_obj, &rel_view, PyBUF_CONTIG_RO) < 0) {
        PyBuffer_Release(&rows_view);
        return NULL;
    }
    if (PyObject_GetBuffer(conf_obj, &conf_view, PyBUF_CONTIG_RO) < 0) {
        PyBuffer_Release(&rows_view);
        PyBuffer_Release(&rel_view);
        return NULL;
    }
    const int32_t *rows = (const int32_t *)rows_view.buf;
    const double *rel = (const double *)rel_view.buf;
    const double *conf = (const double *)conf_view.buf;
    Py_ssize_t n = rows_view.len / 4;
    Py_ssize_t value_rows = rel_view.len / 8;
    if (conf_view.len != rel_view.len || rows_view.len % 4 != 0) {
        PyErr_SetString(PyExc_ValueError,
                        "rows must be int32; rel/conf must be equal-length "
                        "float64 columns");
        goto fail_views;
    }
    Py_ssize_t iso_len = PyList_GET_SIZE(iso_obj);

    /* Pre-validate rows and pre-extract iso UTF-8 views while binding is
     * still cheap to abort; utf8 caches live on the str objects the iso
     * list keeps alive for the whole call. */
    typedef struct { const char *buf; Py_ssize_t len; } strview_t;
    strview_t *iso_views = PyMem_Malloc((size_t)(n ? n : 1) * sizeof(strview_t));
    if (!iso_views) {
        PyErr_NoMemory();
        goto fail_views;
    }
    for (Py_ssize_t i = 0; i < n; i++) {
        int32_t row = rows[i];
        if (row < 0 || (size_t)row >= self->used || row >= value_rows ||
            row >= iso_len) {
            PyErr_Format(PyExc_IndexError,
                         "row %d out of range of the map/columns", row);
            PyMem_Free(iso_views);
            goto fail_views;
        }
        if (!memchr(self->arena + self->rows[row].off, '\0',
                    self->rows[row].len)) {
            PyErr_Format(PyExc_ValueError,
                         "row %d is a single-string key, not a pair", row);
            PyMem_Free(iso_views);
            goto fail_views;
        }
        PyObject *iso_item = PyList_GET_ITEM(iso_obj, row);
        iso_views[i].buf = utf8_of(iso_item, &iso_views[i].len);
        if (!iso_views[i].buf) {
            PyMem_Free(iso_views);
            goto fail_views;
        }
    }

    sqlite3 *db = NULL;
    sqlite3_stmt *stmt = NULL;
    if (ff_sql.open_v2(path, &db,
                       FF_SQLITE_OPEN_READWRITE | FF_SQLITE_OPEN_CREATE,
                       NULL) != FF_SQLITE_OK) {
        sqlite_fail(db, NULL, "open");
        goto fail_iso;
    }
    /* Match the sqlite3 module's default 5 s busy wait so a concurrent
     * reader holding the lock briefly delays the flush instead of
     * failing it. */
    ff_sql.busy_timeout(db, 5000);
    /* 16 KB pages for FRESH checkpoint files (fewer B-tree nodes for long
     * text rows; measured ~13% on the bulk insert). Must precede WAL and
     * the first write; a no-op on existing files, whose page size is
     * fixed — any sqlite >= 3.12 reads either. 256 MB page cache for the
     * bulk transaction: the default ~2 MB cache thrashes on a
     * multi-million-row B-tree (measured 1.5x slower at 4M rows);
     * connection-local, not persisted in the file. */
    if (ff_sql.exec(db, "PRAGMA page_size=16384", NULL, NULL, NULL) !=
            FF_SQLITE_OK ||
        ff_sql.exec(db, "PRAGMA journal_mode=WAL", NULL, NULL, NULL) !=
            FF_SQLITE_OK ||
        ff_sql.exec(db, "PRAGMA foreign_keys=ON", NULL, NULL, NULL) !=
            FF_SQLITE_OK ||
        ff_sql.exec(db, "PRAGMA cache_size=-262144", NULL, NULL, NULL) !=
            FF_SQLITE_OK ||
        ff_sql.exec(db, FF_SCHEMA_SQL, NULL, NULL, NULL) != FF_SQLITE_OK) {
        sqlite_fail(db, NULL, "schema");
        goto fail_iso;
    }

    /* Empty table => plain INSERT (same fast path as put_rows). */
    int empty = 0;
    if (ff_sql.prepare_v2(db, "SELECT NOT EXISTS (SELECT 1 FROM sources)",
                          -1, &stmt, NULL) != FF_SQLITE_OK ||
        ff_sql.step(stmt) != FF_SQLITE_ROW) {
        sqlite_fail(db, stmt, "empty probe");
        goto fail_iso;
    }
    empty = ff_sql.column_int(stmt, 0);
    ff_sql.finalize(stmt);
    stmt = NULL;

    if (ff_sql.exec(db, "BEGIN", NULL, NULL, NULL) != FF_SQLITE_OK ||
        ff_sql.prepare_v2(db, empty ? FF_INSERT_SQL : FF_UPSERT_SQL, -1,
                          &stmt, NULL) != FF_SQLITE_OK) {
        sqlite_fail(db, stmt, "begin");
        goto fail_iso;
    }
    for (Py_ssize_t i = 0; i < n; i++) {
        int32_t row = rows[i];
        const char *key = self->arena + self->rows[row].off;
        size_t key_len = self->rows[row].len;
        const char *sep = memchr(key, '\0', key_len);
        if (ff_sql.bind_text(stmt, 1, key, (int)(sep - key),
                             FF_SQLITE_STATIC) != FF_SQLITE_OK ||
            ff_sql.bind_text(stmt, 2, sep + 1,
                             (int)(key_len - (size_t)(sep - key) - 1),
                             FF_SQLITE_STATIC) != FF_SQLITE_OK ||
            ff_sql.bind_double(stmt, 3, rel[row]) != FF_SQLITE_OK ||
            ff_sql.bind_double(stmt, 4, conf[row]) != FF_SQLITE_OK ||
            ff_sql.bind_text(stmt, 5, iso_views[i].buf,
                             (int)iso_views[i].len, FF_SQLITE_STATIC) !=
                FF_SQLITE_OK ||
            ff_sql.step(stmt) != FF_SQLITE_DONE ||
            ff_sql.reset(stmt) != FF_SQLITE_OK) {
            sqlite_fail(db, stmt, "insert");
            goto fail_iso;
        }
    }
    ff_sql.finalize(stmt);
    stmt = NULL;
    if (ff_sql.exec(db, "COMMIT", NULL, NULL, NULL) != FF_SQLITE_OK) {
        sqlite_fail(db, NULL, "commit");
        goto fail_iso;
    }
    ff_sql.close(db);
    PyMem_Free(iso_views);
    PyBuffer_Release(&rows_view);
    PyBuffer_Release(&rel_view);
    PyBuffer_Release(&conf_view);
    return PyLong_FromSsize_t(n);

fail_iso:
    PyMem_Free(iso_views);
fail_views:
    PyBuffer_Release(&rows_view);
    PyBuffer_Release(&rel_view);
    PyBuffer_Release(&conf_view);
    return NULL;
}

/* snapshot_rows(rows, rel, conf, iso) -> bytes
 *
 * A self-contained copy of everything a checkpoint flush needs for the
 * given rows, in write order. Layout (native endianness, 8-aligned):
 *
 *   [0]        int64  n
 *   [8]        int64  heap_off        (string heap's offset in the blob)
 *   [16]       double vals[2n]        (reliability, confidence) per row
 *   [16+16n]   int32  meta[6n]        (src_off, src_len, mkt_off, mkt_len,
 *                                      iso_off, iso_len), heap-relative
 *   [heap_off] string heap bytes
 *
 * The point of the copy: flush_sqlite must hold the GIL for its whole
 * write (its SQLITE_STATIC bindings alias the live arena, which a
 * concurrent intern may realloc). A snapshot owns its bytes, so
 * flush_snapshot() below can release the GIL for the entire SQLite
 * transaction and a background checkpoint thread truly overlaps with
 * ingest/settle host work (state/tensor_store.flush_to_sqlite_async).
 */
static PyObject *
InternMap_snapshot_rows(InternMap *self, PyObject *args)
{
    PyObject *rows_obj, *rel_obj, *conf_obj, *iso_obj;
    if (!PyArg_ParseTuple(args, "OOOO", &rows_obj, &rel_obj, &conf_obj,
                          &iso_obj))
        return NULL;
    if (!PyList_Check(iso_obj)) {
        PyErr_SetString(PyExc_TypeError, "iso must be a list of str");
        return NULL;
    }

    Py_buffer rows_view, rel_view, conf_view;
    if (PyObject_GetBuffer(rows_obj, &rows_view, PyBUF_CONTIG_RO) < 0)
        return NULL;
    if (PyObject_GetBuffer(rel_obj, &rel_view, PyBUF_CONTIG_RO) < 0) {
        PyBuffer_Release(&rows_view);
        return NULL;
    }
    if (PyObject_GetBuffer(conf_obj, &conf_view, PyBUF_CONTIG_RO) < 0) {
        PyBuffer_Release(&rows_view);
        PyBuffer_Release(&rel_view);
        return NULL;
    }
    const int32_t *rows = (const int32_t *)rows_view.buf;
    const double *rel = (const double *)rel_view.buf;
    const double *conf = (const double *)conf_view.buf;
    Py_ssize_t n = rows_view.len / 4;
    Py_ssize_t value_rows = rel_view.len / 8;
    PyObject *blob = NULL;
    typedef struct { const char *buf; Py_ssize_t len; } strview_t;
    strview_t *iso_views = NULL;
    if (conf_view.len != rel_view.len || rows_view.len % 4 != 0) {
        PyErr_SetString(PyExc_ValueError,
                        "rows must be int32; rel/conf must be equal-length "
                        "float64 columns");
        goto out;
    }
    Py_ssize_t iso_len = PyList_GET_SIZE(iso_obj);

    iso_views = PyMem_Malloc((size_t)(n ? n : 1) * sizeof(strview_t));
    if (!iso_views) {
        PyErr_NoMemory();
        goto out;
    }
    /* Validate + measure the heap in one pass (utf8 views cache on the
     * str objects the iso list keeps alive for this call). */
    int64_t heap_len = 0;
    for (Py_ssize_t i = 0; i < n; i++) {
        int32_t row = rows[i];
        if (row < 0 || (size_t)row >= self->used || row >= value_rows ||
            row >= iso_len) {
            PyErr_Format(PyExc_IndexError,
                         "row %d out of range of the map/columns", row);
            goto out;
        }
        if (!memchr(self->arena + self->rows[row].off, '\0',
                    self->rows[row].len)) {
            PyErr_Format(PyExc_ValueError,
                         "row %d is a single-string key, not a pair", row);
            goto out;
        }
        PyObject *iso_item = PyList_GET_ITEM(iso_obj, row);
        iso_views[i].buf = utf8_of(iso_item, &iso_views[i].len);
        if (!iso_views[i].buf) goto out;
        /* Key bytes minus the NUL separator + the iso stamp. */
        heap_len += (int64_t)self->rows[row].len - 1 + iso_views[i].len;
    }

    int64_t heap_off = 16 + 16 * (int64_t)n + 24 * (int64_t)n;
    if (heap_len > INT32_MAX) {
        PyErr_SetString(PyExc_OverflowError,
                        "snapshot heap exceeds int32 offsets");
        goto out;
    }
    blob = PyBytes_FromStringAndSize(NULL, (Py_ssize_t)(heap_off + heap_len));
    if (!blob) goto out;
    char *base = PyBytes_AS_STRING(blob);
    ((int64_t *)base)[0] = n;
    ((int64_t *)base)[1] = heap_off;
    double *vals = (double *)(base + 16);
    int32_t *meta = (int32_t *)(base + 16 + 16 * n);
    char *heap = base + heap_off;
    int32_t cursor = 0;
    for (Py_ssize_t i = 0; i < n; i++) {
        int32_t row = rows[i];
        const char *key = self->arena + self->rows[row].off;
        size_t key_len = self->rows[row].len;
        const char *sep = memchr(key, '\0', key_len);
        int32_t src_len = (int32_t)(sep - key);
        int32_t mkt_len = (int32_t)(key_len - (size_t)src_len - 1);
        vals[2 * i] = rel[row];
        vals[2 * i + 1] = conf[row];
        meta[6 * i] = cursor;
        meta[6 * i + 1] = src_len;
        memcpy(heap + cursor, key, (size_t)src_len);
        cursor += src_len;
        meta[6 * i + 2] = cursor;
        meta[6 * i + 3] = mkt_len;
        memcpy(heap + cursor, sep + 1, (size_t)mkt_len);
        cursor += mkt_len;
        meta[6 * i + 4] = cursor;
        meta[6 * i + 5] = (int32_t)iso_views[i].len;
        memcpy(heap + cursor, iso_views[i].buf, (size_t)iso_views[i].len);
        cursor += (int32_t)iso_views[i].len;
    }

out:
    PyMem_Free(iso_views);
    PyBuffer_Release(&rows_view);
    PyBuffer_Release(&rel_view);
    PyBuffer_Release(&conf_view);
    return blob;
}

/* flush_snapshot(path, blob) -> written row count.
 *
 * The GIL-free twin of flush_sqlite over a snapshot_rows() blob: every
 * binding points into the blob (owned bytes — nothing can move under it),
 * so the whole SQLite transaction runs with the GIL RELEASED and a
 * background flush thread overlaps with foreground Python. Identical
 * observable file semantics to flush_sqlite (same pragmas, schema,
 * empty-table INSERT fast path, UPSERT otherwise, one transaction).
 */
static PyObject *
internmap_flush_snapshot(PyObject *Py_UNUSED(module), PyObject *args)
{
    const char *path;
    Py_buffer blob;
    if (!PyArg_ParseTuple(args, "sy*", &path, &blob))
        return NULL;
    if (sqlite_runtime_load() < 0) {
        PyBuffer_Release(&blob);
        PyErr_SetString(PyExc_RuntimeError,
                        "libsqlite3 runtime library not available");
        return NULL;
    }
    const char *base = (const char *)blob.buf;
    if (blob.len < 16) {
        PyBuffer_Release(&blob);
        PyErr_SetString(PyExc_ValueError, "snapshot blob truncated");
        return NULL;
    }
    int64_t n = ((const int64_t *)base)[0];
    int64_t heap_off = ((const int64_t *)base)[1];
    int64_t heap_len = (int64_t)blob.len - heap_off;
    /* Bound n BEFORE the 16 + 40*n multiply: a corrupt blob with a huge n
     * would overflow the int64 (UB) and could wrap past this check. */
    if (n < 0 || n > ((int64_t)blob.len - 16) / 40 ||
        heap_off != 16 + 40 * n || heap_off > (int64_t)blob.len) {
        PyBuffer_Release(&blob);
        PyErr_SetString(PyExc_ValueError, "malformed snapshot blob header");
        return NULL;
    }
    const double *vals = (const double *)(base + 16);
    const int32_t *meta = (const int32_t *)(base + 16 + 16 * n);
    const char *heap = base + heap_off;
    /* Bounds-check every span with the GIL still held (errors can raise
     * here; the no-GIL region below must be exception-free). */
    for (int64_t i = 0; i < n; i++) {
        const int32_t *m = meta + 6 * i;
        for (int half = 0; half < 3; half++) {
            int64_t off = m[2 * half], len = m[2 * half + 1];
            if (off < 0 || len < 0 || off + len > heap_len) {
                PyBuffer_Release(&blob);
                PyErr_SetString(PyExc_ValueError,
                                "snapshot span out of bounds");
                return NULL;
            }
        }
    }

    const char *fail_step = NULL;
    char fail_msg[256] = "";
    sqlite3 *db = NULL;
    sqlite3_stmt *stmt = NULL;

    Py_BEGIN_ALLOW_THREADS
#define FF_NOGIL_FAIL(step)                                              \
    do {                                                                 \
        fail_step = (step);                                              \
        snprintf(fail_msg, sizeof(fail_msg), "%s",                       \
                 db ? ff_sql.errmsg(db) : "library unavailable");        \
        goto nogil_done;                                                 \
    } while (0)

    if (ff_sql.open_v2(path, &db,
                       FF_SQLITE_OPEN_READWRITE | FF_SQLITE_OPEN_CREATE,
                       NULL) != FF_SQLITE_OK)
        FF_NOGIL_FAIL("open");
    ff_sql.busy_timeout(db, 5000);
    if (ff_sql.exec(db, "PRAGMA page_size=16384", NULL, NULL, NULL) !=
            FF_SQLITE_OK ||
        ff_sql.exec(db, "PRAGMA journal_mode=WAL", NULL, NULL, NULL) !=
            FF_SQLITE_OK ||
        ff_sql.exec(db, "PRAGMA foreign_keys=ON", NULL, NULL, NULL) !=
            FF_SQLITE_OK ||
        ff_sql.exec(db, "PRAGMA cache_size=-262144", NULL, NULL, NULL) !=
            FF_SQLITE_OK ||
        ff_sql.exec(db, FF_SCHEMA_SQL, NULL, NULL, NULL) != FF_SQLITE_OK)
        FF_NOGIL_FAIL("schema");

    int empty = 0;
    if (ff_sql.prepare_v2(db, "SELECT NOT EXISTS (SELECT 1 FROM sources)",
                          -1, &stmt, NULL) != FF_SQLITE_OK ||
        ff_sql.step(stmt) != FF_SQLITE_ROW)
        FF_NOGIL_FAIL("empty probe");
    empty = ff_sql.column_int(stmt, 0);
    ff_sql.finalize(stmt);
    stmt = NULL;

    if (ff_sql.exec(db, "BEGIN", NULL, NULL, NULL) != FF_SQLITE_OK ||
        ff_sql.prepare_v2(db, empty ? FF_INSERT_SQL : FF_UPSERT_SQL, -1,
                          &stmt, NULL) != FF_SQLITE_OK)
        FF_NOGIL_FAIL("begin");
    for (int64_t i = 0; i < n; i++) {
        const int32_t *m = meta + 6 * i;
        if (ff_sql.bind_text(stmt, 1, heap + m[0], m[1],
                             FF_SQLITE_STATIC) != FF_SQLITE_OK ||
            ff_sql.bind_text(stmt, 2, heap + m[2], m[3],
                             FF_SQLITE_STATIC) != FF_SQLITE_OK ||
            ff_sql.bind_double(stmt, 3, vals[2 * i]) != FF_SQLITE_OK ||
            ff_sql.bind_double(stmt, 4, vals[2 * i + 1]) != FF_SQLITE_OK ||
            ff_sql.bind_text(stmt, 5, heap + m[4], m[5],
                             FF_SQLITE_STATIC) != FF_SQLITE_OK ||
            ff_sql.step(stmt) != FF_SQLITE_DONE ||
            ff_sql.reset(stmt) != FF_SQLITE_OK)
            FF_NOGIL_FAIL("insert");
    }
    ff_sql.finalize(stmt);
    stmt = NULL;
    if (ff_sql.exec(db, "COMMIT", NULL, NULL, NULL) != FF_SQLITE_OK)
        FF_NOGIL_FAIL("commit");
    ff_sql.close(db);
    db = NULL;

nogil_done:
    if (fail_step) {
        if (stmt) ff_sql.finalize(stmt);
        if (db) {
            ff_sql.exec(db, "ROLLBACK", NULL, NULL, NULL);
            ff_sql.close(db);
        }
    }
#undef FF_NOGIL_FAIL
    Py_END_ALLOW_THREADS

    PyBuffer_Release(&blob);
    if (fail_step) {
        PyErr_Format(PyExc_RuntimeError, "sqlite checkpoint (%s): %s",
                     fail_step, fail_msg);
        return NULL;
    }
    return PyLong_FromSsize_t((Py_ssize_t)n);
}

/* ---- type ---------------------------------------------------------------- */

static PyObject *
InternMap_new(PyTypeObject *type, PyObject *Py_UNUSED(args),
              PyObject *Py_UNUSED(kwargs))
{
    InternMap *self = (InternMap *)type->tp_alloc(type, 0);
    if (!self) return NULL;
    self->capacity = 64;
    self->used = 0;
    self->slots = PyMem_Calloc(self->capacity, sizeof(slot_t));
    self->arena_cap = 1024;
    self->arena_used = 0;
    self->arena = PyMem_Malloc(self->arena_cap);
    self->rows_cap = 64;
    self->rows = PyMem_Malloc(self->rows_cap * sizeof(rowref_t));
    if (!self->slots || !self->arena || !self->rows) {
        Py_DECREF(self);
        PyErr_NoMemory();
        return NULL;
    }
    return (PyObject *)self;
}

static void
InternMap_dealloc(InternMap *self)
{
    PyMem_Free(self->slots);
    PyMem_Free(self->arena);
    PyMem_Free(self->rows);
    Py_TYPE(self)->tp_free((PyObject *)self);
}

static PyMethodDef InternMap_methods[] = {
    {"intern", (PyCFunction)InternMap_intern, METH_O,
     "intern(id) -> row (assigning the next row if new)"},
    {"intern_pair", (PyCFunction)InternMap_intern_pair, METH_VARARGS,
     "intern_pair(a, b) -> row for the (a, b) pair key"},
    {"intern_batch", (PyCFunction)InternMap_intern_batch, METH_O,
     "intern_batch(seq) -> bytearray of int32 rows"},
    {"intern_pairs", (PyCFunction)InternMap_intern_pairs, METH_VARARGS,
     "intern_pairs(seq_a, seq_b) -> bytearray of int32 rows"},
    {"intern_pairs_indexed",
     (PyCFunction)InternMap_intern_pairs_indexed, METH_VARARGS,
     "intern_pairs_indexed(a_table, a_codes, b_table, b_codes) -> rows"},
    {"probe_pairs_indexed",
     (PyCFunction)InternMap_probe_pairs_indexed, METH_VARARGS,
     "probe_pairs_indexed(a_table, a_codes, b_table, b_codes, rows, "
     "hashes, slots, start, stop) -> miss count (lookup only, GIL "
     "released)"},
    {"commit_probed", (PyCFunction)InternMap_commit_probed, METH_VARARGS,
     "commit_probed(a_table, a_codes, b_table, b_codes, rows, hashes, "
     "slots, probed_capacity) -> interned miss count (in batch order)"},
    {"reserve_pairs", (PyCFunction)InternMap_reserve_pairs, METH_O,
     "reserve_pairs(n) -> capacity token (pre-size before a probe pass)"},
    {"lookup", (PyCFunction)InternMap_lookup, METH_O,
     "lookup(id) -> row or -1 (no insertion)"},
    {"lookup_pair", (PyCFunction)InternMap_lookup_pair, METH_VARARGS,
     "lookup_pair(a, b) -> row or -1 (no insertion)"},
    {"lookup_pairs", (PyCFunction)InternMap_lookup_pairs, METH_VARARGS,
     "lookup_pairs(seq_a, seq_b) -> bytearray of int32 rows (-1 when absent)"},
    {"ids", (PyCFunction)InternMap_ids, METH_NOARGS,
     "ids() -> all interned ids in row order"},
    {"id_of", (PyCFunction)InternMap_id_of, METH_O,
     "id_of(row) -> the id interned at row"},
    {"sorted_rows", (PyCFunction)InternMap_sorted_rows, METH_O,
     "sorted_rows(int32 buffer) -> bytearray of the rows in key order"},
    {"flush_sqlite", (PyCFunction)InternMap_flush_sqlite, METH_VARARGS,
     "flush_sqlite(path, rows, rel, conf, iso) -> written row count"},
    {"snapshot_rows", (PyCFunction)InternMap_snapshot_rows, METH_VARARGS,
     "snapshot_rows(rows, rel, conf, iso) -> self-contained flush blob"},
    {"pair_blob", (PyCFunction)InternMap_pair_blob, METH_VARARGS,
     "pair_blob(lo, hi) -> journal wire-format bytes for rows [lo, hi)"},
    {NULL, NULL, 0, NULL},
};

/* delta_match_rows(rank_map, pr_new, po_new, pr_old, po_old, prev_of,
 *                  rows_old, rows_out) -> matched pair count
 *
 * The per-market match pass of the epoch-persistent pair table
 * (state/tensor_store.py): market *m* of the NEW batch matches old
 * market prev_of[m] (identity when prev_of is None) iff their pair
 * counts are equal and every pair's source rank maps elementwise
 * (rank_map translates new ranks to the old batch's; None means the
 * source tables are identical and the comparison is a raw memcmp).
 * Matched markets copy their resolved rows from rows_old; every other
 * position gets -1 — the miss set the interner then walks. One
 * sequential O(P) pass at memcmp/memcpy speed, GIL released (pure
 * buffers). Offsets must be non-decreasing and in range (checked).
 *
 * Buffers: rank_map i32[U] or None, pr_new i32[P_new], po_new i64[M+1],
 * pr_old i32[P_old], po_old i64[M_old+1], prev_of i64[M] or None,
 * rows_old i32[>= P_old], rows_out i32[P_new] (writable, fully
 * overwritten).
 */
static PyObject *
internmap_delta_match_rows(PyObject *Py_UNUSED(module), PyObject *args)
{
    PyObject *rank_obj, *prev_obj;
    PyObject *prn_obj, *pon_obj, *pro_obj, *poo_obj, *rowso_obj, *out_obj;
    if (!PyArg_ParseTuple(args, "OOOOOOOO", &rank_obj, &prn_obj, &pon_obj,
                          &pro_obj, &poo_obj, &prev_obj, &rowso_obj,
                          &out_obj))
        return NULL;

    Py_buffer rank_v, prn_v, pon_v, pro_v, poo_v, prev_v, rowso_v, out_v;
    rank_v.obj = prn_v.obj = pon_v.obj = pro_v.obj = poo_v.obj =
        prev_v.obj = rowso_v.obj = out_v.obj = NULL;
#define FF_GETBUF(obj, view, flags)                                       \
    do {                                                                  \
        if (PyObject_GetBuffer(obj, &view, flags) < 0) goto fail;         \
    } while (0)
    if (rank_obj != Py_None) FF_GETBUF(rank_obj, rank_v, PyBUF_CONTIG_RO);
    FF_GETBUF(prn_obj, prn_v, PyBUF_CONTIG_RO);
    FF_GETBUF(pon_obj, pon_v, PyBUF_CONTIG_RO);
    FF_GETBUF(pro_obj, pro_v, PyBUF_CONTIG_RO);
    FF_GETBUF(poo_obj, poo_v, PyBUF_CONTIG_RO);
    if (prev_obj != Py_None) FF_GETBUF(prev_obj, prev_v, PyBUF_CONTIG_RO);
    FF_GETBUF(rowso_obj, rowso_v, PyBUF_CONTIG_RO);
    FF_GETBUF(out_obj, out_v, PyBUF_CONTIG);
#undef FF_GETBUF

    if (pon_v.len < 8 || pon_v.len % 8 != 0 || poo_v.len < 8 ||
        poo_v.len % 8 != 0 || prn_v.len % 4 != 0 || pro_v.len % 4 != 0 ||
        rowso_v.len % 4 != 0 || out_v.len != prn_v.len ||
        (rank_v.obj && rank_v.len % 4 != 0) ||
        (prev_v.obj && prev_v.len % 8 != 0)) {
        PyErr_SetString(PyExc_ValueError,
                        "delta_match_rows: malformed buffer shapes");
        goto fail;
    }
    const int32_t *rank_map = rank_v.obj ? (const int32_t *)rank_v.buf
                                         : NULL;
    Py_ssize_t n_rank = rank_v.obj ? rank_v.len / 4 : 0;
    const int32_t *pr_new = (const int32_t *)prn_v.buf;
    const int64_t *po_new = (const int64_t *)pon_v.buf;
    const int32_t *pr_old = (const int32_t *)pro_v.buf;
    const int64_t *po_old = (const int64_t *)poo_v.buf;
    const int64_t *prev_of = prev_v.obj ? (const int64_t *)prev_v.buf
                                        : NULL;
    const int32_t *rows_old = (const int32_t *)rowso_v.buf;
    int32_t *rows_out = (int32_t *)out_v.buf;
    Py_ssize_t m_new = pon_v.len / 8 - 1;
    Py_ssize_t m_old = poo_v.len / 8 - 1;
    Py_ssize_t p_new = prn_v.len / 4;
    Py_ssize_t p_old = pro_v.len / 4;
    Py_ssize_t n_rows_old = rowso_v.len / 4;
    if ((prev_v.obj && prev_v.len / 8 != m_new) ||
        (!prev_v.obj && m_new > m_old) || n_rows_old < p_old) {
        PyErr_SetString(PyExc_ValueError,
                        "delta_match_rows: table sizes do not line up");
        goto fail;
    }

    Py_ssize_t matched_pairs = 0;
    Py_ssize_t bad_market = -1;
    Py_BEGIN_ALLOW_THREADS
    for (Py_ssize_t m = 0; m < m_new; m++) {
        int64_t lo = po_new[m], hi = po_new[m + 1];
        if (lo < 0 || hi < lo || hi > p_new) {
            bad_market = m;
            break;
        }
        int64_t c = hi - lo;
        int64_t pm = prev_of ? prev_of[m] : (int64_t)m;
        int matched = 0;
        int64_t plo = 0;
        if (pm >= 0 && pm < m_old) {
            plo = po_old[pm];
            int64_t phi = po_old[pm + 1];
            if (plo >= 0 && phi >= plo && phi <= p_old && phi - plo == c) {
                if (!rank_map) {
                    matched = memcmp(pr_new + lo, pr_old + plo,
                                     (size_t)c * 4) == 0;
                } else {
                    matched = 1;
                    for (int64_t k = 0; k < c; k++) {
                        int32_t r = pr_new[lo + k];
                        if (r < 0 || r >= n_rank ||
                            rank_map[r] != pr_old[plo + k]) {
                            matched = 0;
                            break;
                        }
                    }
                }
            }
        }
        if (matched) {
            memcpy(rows_out + lo, rows_old + plo, (size_t)c * 4);
            matched_pairs += c;
        } else {
            for (int64_t k = lo; k < hi; k++) rows_out[k] = -1;
        }
    }
    Py_END_ALLOW_THREADS
#define FF_RELEASE_ALL()                                                  \
    do {                                                                  \
        if (rank_v.obj) PyBuffer_Release(&rank_v);                        \
        PyBuffer_Release(&prn_v);                                         \
        PyBuffer_Release(&pon_v);                                         \
        PyBuffer_Release(&pro_v);                                         \
        PyBuffer_Release(&poo_v);                                         \
        if (prev_v.obj) PyBuffer_Release(&prev_v);                        \
        PyBuffer_Release(&rowso_v);                                       \
        PyBuffer_Release(&out_v);                                         \
    } while (0)
    if (bad_market >= 0) {
        PyErr_Format(PyExc_ValueError,
                     "delta_match_rows: offsets for market %zd out of "
                     "range", bad_market);
        FF_RELEASE_ALL();
        return NULL;
    }
    FF_RELEASE_ALL();
#undef FF_RELEASE_ALL
    return PyLong_FromSsize_t(matched_pairs);

fail:
    if (rank_v.obj) PyBuffer_Release(&rank_v);
    if (prn_v.obj) PyBuffer_Release(&prn_v);
    if (pon_v.obj) PyBuffer_Release(&pon_v);
    if (pro_v.obj) PyBuffer_Release(&pro_v);
    if (poo_v.obj) PyBuffer_Release(&poo_v);
    if (prev_v.obj) PyBuffer_Release(&prev_v);
    if (rowso_v.obj) PyBuffer_Release(&rowso_v);
    if (out_v.obj) PyBuffer_Release(&out_v);
    return NULL;
}

/* sqlite_writer_available() -> bool: whether flush_sqlite can run here
 * (libsqlite3 dlopen()able). Lets callers choose a fallback up front
 * instead of catching the writer's genuine I/O errors. */
static PyObject *
internmap_sqlite_writer_available(PyObject *Py_UNUSED(module),
                                  PyObject *Py_UNUSED(ignored))
{
    return PyBool_FromLong(sqlite_runtime_load() > 0);
}

static PySequenceMethods InternMap_as_sequence = {
    .sq_length = (lenfunc)InternMap_len,
};

static PyTypeObject InternMapType = {
    PyVarObject_HEAD_INIT(NULL, 0)
    .tp_name = "internmap.InternMap",
    .tp_basicsize = sizeof(InternMap),
    .tp_flags = Py_TPFLAGS_DEFAULT,
    .tp_doc = "Open-addressing string/pair interning map with int32 rows",
    .tp_new = InternMap_new,
    .tp_dealloc = (destructor)InternMap_dealloc,
    .tp_methods = InternMap_methods,
    .tp_as_sequence = &InternMap_as_sequence,
};

static PyMethodDef internmap_functions[] = {
    {"sqlite_writer_available", internmap_sqlite_writer_available,
     METH_NOARGS, "whether flush_sqlite's libsqlite3 runtime is loadable"},
    {"flush_snapshot", internmap_flush_snapshot, METH_VARARGS,
     "flush_snapshot(path, blob) -> row count (GIL released during write)"},
    {"pack_strings", internmap_pack_strings, METH_O,
     "pack_strings(list[str]) -> u32-length-prefixed UTF-8 blob"},
    {"delta_match_rows", internmap_delta_match_rows, METH_VARARGS,
     "delta_match_rows(rank_map, pr_new, po_new, pr_old, po_old, "
     "prev_of, rows_old, rows_out) -> matched pair count"},
    {NULL, NULL, 0, NULL},
};

static PyModuleDef internmap_module = {
    PyModuleDef_HEAD_INIT,
    .m_name = "internmap",
    .m_doc = "Native id interning for the TPU host boundary",
    .m_size = -1,
    .m_methods = internmap_functions,
};

PyMODINIT_FUNC
PyInit_internmap(void)
{
    /* pair_blob/pack_strings write u32 lengths in host order and the
     * journal format is little-endian: refuse to load on a big-endian
     * host rather than write unreadable journals. */
    const uint32_t one = 1;
    if (*(const unsigned char *)&one != 1) {
        PyErr_SetString(PyExc_ImportError,
                        "internmap requires a little-endian host");
        return NULL;
    }
    if (PyType_Ready(&InternMapType) < 0) return NULL;
    PyObject *module = PyModule_Create(&internmap_module);
    if (!module) return NULL;
    Py_INCREF(&InternMapType);
    if (PyModule_AddObject(module, "InternMap", (PyObject *)&InternMapType) < 0) {
        Py_DECREF(&InternMapType);
        Py_DECREF(module);
        return NULL;
    }
    return module;
}
