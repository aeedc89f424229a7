// Native grouping pass of the base-delta wire encoding
// (cluster/encode.py), a copy of the JAX package's encode.cc with one
// change: an empty slot of the key table is marked by its row (-1), not
// by key 0, so the keys 0 and 1 never share a group.
//
// Per probe, hash each pooled row (multiply-add), key it by (min, max) of
// the hashed row, and attach verified near-duplicates (exact diff count
// <= max_diffs) to the first row seen with their key, pinned rows
// claiming their keys first.  That is numpy _group_rows's (key,
// pinned-first) stable sort, so rep_of[N] int64 (-1 = full lane) is the
// numpy encoder's, element for element (tests/test_torch_native.py), with
// its no-chain invariant: a row with children is pinned and never itself
// becomes a delta row.

#define PY_SSIZE_T_CLEAN
#include <Python.h>
#define NPY_NO_DEPRECATED_API NPY_1_7_API_VERSION
#include <numpy/arrayobject.h>

#include <cstdint>
#include <vector>

namespace {

constexpr uint32_t kProbes[][2] = {
    {0x9E3779B1u, 0x85EBCA77u},
    {0xC2B2AE3Du, 0x27D4EB2Fu},
    {0x165667B1u, 0x9E3779B9u},
    {0x85EBCA6Bu, 0xC2B2AE35u},
};
constexpr int kMaxProbes = 4;

uint64_t sketch_key(const uint32_t *row, npy_intp s, uint32_t a, uint32_t b) {
  uint32_t mn = 0xFFFFFFFFu, mx = 0;
  for (npy_intp j = 0; j < s; j++) {
    const uint32_t h = row[j] * a + b;  // wraps, same as numpy uint32
    if (h < mn) mn = h;
    if (h > mx) mx = h;
  }
  return (static_cast<uint64_t>(mn) << 32) | mx;
}

// Open-addressing key -> first-row table.  The raw (min << 32 | max)
// keys concentrate their high bits (both order statistics live in narrow
// bands), so slots come from a splitmix64 finalizer; linear probing at
// <= 50% load.  A slot is empty while its row is -1: every key, 0
// included, is a key of its own.
struct FirstSeen {
  std::vector<uint64_t> keys;
  std::vector<int64_t> rows;
  uint64_t mask = 0;

  void reset(size_t n_entries) {
    size_t cap = 16;
    while (cap < n_entries * 2) cap <<= 1;
    keys.assign(cap, 0);
    rows.assign(cap, -1);
    mask = cap - 1;
  }

  static uint64_t mix(uint64_t x) {
    x += 0x9E3779B97F4A7C15ull;
    x = (x ^ (x >> 30)) * 0xBF58476D1CE4E5B9ull;
    x = (x ^ (x >> 27)) * 0x94D049BB133111EBull;
    return x ^ (x >> 31);
  }

  // Returns the first row seen with `key`, inserting `row` if new.
  int64_t insert_or_get(uint64_t key, int64_t row) {
    uint64_t i = mix(key) & mask;
    for (;; i = (i + 1) & mask) {
      if (rows[i] < 0) {
        keys[i] = key;
        rows[i] = row;
        return row;
      }
      if (keys[i] == key) return rows[i];
    }
  }
};

void group_rows(const uint32_t *items, npy_intp n, npy_intp s, int max_diffs,
                int n_probes, int64_t *rep_of) {
  std::vector<uint8_t> pinned(static_cast<size_t>(n), 0);
  std::vector<int64_t> pool(static_cast<size_t>(n));
  for (npy_intp i = 0; i < n; i++) {
    rep_of[i] = -1;
    pool[static_cast<size_t>(i)] = i;
  }
  std::vector<uint64_t> keys;
  FirstSeen first;
  for (int p = 0; p < n_probes && p < kMaxProbes; p++) {
    if (pool.size() < 2) break;
    keys.resize(pool.size());
    for (size_t k = 0; k < pool.size(); k++)
      keys[k] = sketch_key(items + pool[k] * s, s, kProbes[p][0],
                           kProbes[p][1]);
    first.reset(pool.size());
    // Pinned rows claim their key first (ascending order), so stragglers
    // attach to existing bases instead of spawning a duplicate base: the
    // numpy encoder's (key, pinned-first) sort.
    for (size_t k = 0; k < pool.size(); k++)
      if (pinned[static_cast<size_t>(pool[k])])
        first.insert_or_get(keys[k], pool[k]);
    for (size_t k = 0; k < pool.size(); k++) {
      const int64_t row = pool[k];
      if (pinned[static_cast<size_t>(row)]) continue;
      const int64_t rep = first.insert_or_get(keys[k], row);
      if (rep == row) continue;
      const uint32_t *ra = items + row * s, *rb = items + rep * s;
      int nd = 0;
      for (npy_intp j = 0; j < s && nd <= max_diffs; j++) nd += ra[j] != rb[j];
      if (nd <= max_diffs) {
        rep_of[row] = rep;
        pinned[static_cast<size_t>(rep)] = 1;
      }
    }
    size_t w = 0;
    for (size_t k = 0; k < pool.size(); k++)
      if (rep_of[pool[k]] < 0) pool[w++] = pool[k];
    pool.resize(w);
  }
}

PyObject *group_delta(PyObject *, PyObject *args) {
  PyObject *items_o;
  int max_diffs, n_probes;
  if (!PyArg_ParseTuple(args, "Oii", &items_o, &max_diffs, &n_probes))
    return nullptr;
  PyArrayObject *items = reinterpret_cast<PyArrayObject *>(
      PyArray_FROM_OTF(items_o, NPY_UINT32, NPY_ARRAY_C_CONTIGUOUS));
  if (!items) return nullptr;
  if (PyArray_NDIM(items) != 2) {
    Py_DECREF(items);
    PyErr_SetString(PyExc_ValueError, "items must be 2-D");
    return nullptr;
  }
  const npy_intp n = PyArray_DIM(items, 0), s = PyArray_DIM(items, 1);
  npy_intp dims[1] = {n};
  PyArrayObject *rep = reinterpret_cast<PyArrayObject *>(
      PyArray_SimpleNew(1, dims, NPY_INT64));
  if (!rep) {
    Py_DECREF(items);
    return nullptr;
  }
  const uint32_t *ip = static_cast<const uint32_t *>(PyArray_DATA(items));
  int64_t *rp = static_cast<int64_t *>(PyArray_DATA(rep));
  Py_BEGIN_ALLOW_THREADS;
  group_rows(ip, n, s, max_diffs, n_probes, rp);
  Py_END_ALLOW_THREADS;
  Py_DECREF(items);
  return reinterpret_cast<PyObject *>(rep);
}

PyMethodDef methods[] = {
    {"group_delta", group_delta, METH_VARARGS,
     "group_delta(items[N,S] uint32, max_diffs, n_probes) -> rep_of[N] "
     "int64 (-1 = full lane)"},
    {nullptr, nullptr, 0, nullptr}};

struct PyModuleDef moddef = {PyModuleDef_HEAD_INIT, "_tse1m_torch_encode",
                             "base-delta grouping pass", -1, methods,
                             nullptr, nullptr, nullptr, nullptr};

}  // namespace

PyMODINIT_FUNC PyInit__tse1m_torch_encode(void) {
  import_array();
  return PyModule_Create(&moddef);
}
