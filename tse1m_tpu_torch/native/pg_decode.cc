// Native Postgres decoder: COPY ... TO STDOUT (FORMAT binary) -> typed
// numpy columns in one C++ pass, a copy of the JAX package's pg_decode.cc.
//
// The columnar layer wraps each bulk query in `COPY (SELECT ...) TO STDOUT
// (FORMAT binary)`; libpq streams the rows; the binary frames decode into
// the same column accumulators decode.cc fills (columns.h), so the
// Python-side contract (CodedColumn/BytesColumn/int64-ns lanes) is one.
//
// Binary COPY format (postgresql.org/docs/current/sql-copy.html):
//   header: "PGCOPY\n\377\r\n\0" + int32 flags + int32 extension length
//   tuple:  int16 field count, then per field int32 byte length (-1 =
//           NULL) + payload; trailer: int16 -1
// Per-type payloads used here (all big-endian):
//   timestamptz  int64 microseconds since 2000-01-01 UTC
//   date         int32 days since 2000-01-01
//   float8       IEEE double
//   text         raw bytes (array columns are cast ::text by the wrapper
//                SQL, so their Postgres literal form arrives as text,
//                which data/columnar.py's parse_array reads)
//
// Parity contract (as decode.cc): anything the strict decoders cannot
// prove they handle (unexpected payload widths, infinity timestamps,
// unknown 'p' keys) raises, and the caller falls back to the driver's
// rows.  The parser is exposed on its own (parse_copy_binary) so tests
// cover it without a server.
//
// The libpq prototypes are declared inline because a machine may ship
// libpq.so.5 without its headers; they are the documented, ABI-stable
// public API (postgresql.org/docs/current/libpq.html).

#define PY_SSIZE_T_CLEAN
#include <Python.h>
#define NPY_NO_DEPRECATED_API NPY_1_7_API_VERSION
#include <numpy/arrayobject.h>

#include <cmath>
#include <cstdint>
#include <cstring>
#include <string>
#include <string_view>
#include <unordered_map>
#include <vector>

extern "C" {
typedef struct pg_conn PGconn;
typedef struct pg_result PGresult;
PGconn *PQconnectdb(const char *);
int PQstatus(const PGconn *);
char *PQerrorMessage(const PGconn *);
void PQfinish(PGconn *);
PGresult *PQexec(PGconn *, const char *);
PGresult *PQgetResult(PGconn *);
int PQresultStatus(const PGresult *);
char *PQresultErrorMessage(const PGresult *);
void PQclear(PGresult *);
int PQgetCopyData(PGconn *, char **, int);
void PQfreemem(void *);
}

#define CONNECTION_OK 0
#define PGRES_COMMAND_OK 1
#define PGRES_TUPLES_OK 2
#define PGRES_COPY_OUT 3

namespace {

#include "columns.h"

// ---- COPY binary stream parsing --------------------------------------------

constexpr int64_t kPgEpochNs = 946684800LL * 1000000000LL;  // 2000-01-01 UTC
const char kSignature[11] = {'P', 'G', 'C', 'O', 'P', 'Y',
                             '\n', '\377', '\r', '\n', '\0'};

inline int16_t be16(const uint8_t *p) {
  return static_cast<int16_t>((p[0] << 8) | p[1]);
}
inline int32_t be32(const uint8_t *p) {
  return static_cast<int32_t>((static_cast<uint32_t>(p[0]) << 24) |
                              (static_cast<uint32_t>(p[1]) << 16) |
                              (static_cast<uint32_t>(p[2]) << 8) | p[3]);
}
inline int64_t be64(const uint8_t *p) {
  uint64_t v = 0;
  for (int i = 0; i < 8; i++) v = (v << 8) | p[i];
  return static_cast<int64_t>(v);
}

// Decode the whole stream into cols.  Empty string on success.
std::string parse_stream(const uint8_t *data, size_t size,
                         const SvMap &keymap, std::vector<Col> &cols) {
  const size_t ncol = cols.size();
  size_t pos = 0;
  auto need = [&](size_t n) { return pos + n <= size; };
  if (!need(19) || memcmp(data, kSignature, 11) != 0)
    return "bad COPY binary signature";
  pos = 11;
  const int32_t flags = be32(data + pos);
  pos += 4;
  if (flags & 0xFFFF0000) return "incompatible COPY flags";
  const int32_t extlen = be32(data + pos);
  pos += 4;
  if (extlen < 0 || !need(static_cast<size_t>(extlen)))
    return "bad COPY header extension";
  pos += static_cast<size_t>(extlen);

  for (;;) {
    if (!need(2)) return "truncated stream (no trailer)";
    const int16_t nfields = be16(data + pos);
    pos += 2;
    if (nfields == -1) break;  // trailer
    if (static_cast<size_t>(nfields) != ncol)
      return "field count != spec length";
    for (size_t ci = 0; ci < ncol; ci++) {
      Col &c = cols[ci];
      if (!need(4)) return "truncated field length";
      const int32_t len = be32(data + pos);
      pos += 4;
      const bool null = len < 0;
      if (!null && !need(static_cast<size_t>(len)))
        return "truncated field payload";
      const uint8_t *p = data + pos;
      if (!null) pos += static_cast<size_t>(len);
      switch (c.spec) {
        case 'p': {
          if (null) return "NULL key column";
          auto it = sv_find(keymap, std::string_view(
              reinterpret_cast<const char *>(p),
              static_cast<size_t>(len)));
          if (it == keymap.end()) return "key value not in key_values";
          c.i32.push_back(it->second);
          break;
        }
        case 't': {
          if (null) return "NULL timestamp (caller should fall back)";
          if (len == 8) {  // timestamp(tz): us since 2000-01-01
            const int64_t us = be64(p);
            if (us == INT64_MAX || us == INT64_MIN)
              return "infinity timestamp (caller should fall back)";
            c.i64.push_back(us * 1000 + kPgEpochNs);
          } else if (len == 4) {  // date: days since 2000-01-01
            const int64_t d = be32(p);
            c.i64.push_back(d * 86400LL * 1000000000LL + kPgEpochNs);
          } else {
            return "unexpected timestamp width";
          }
          break;
        }
        case 'f': {
          if (null) {
            c.f64.push_back(Py_NAN);
          } else if (len == 8) {
            const int64_t bits = be64(p);
            double d;
            memcpy(&d, &bits, 8);
            c.f64.push_back(d);
          } else {
            return "unexpected float width (caller should fall back)";
          }
          break;
        }
        case 's':
        case 'c': {
          if (null) {
            c.i32.push_back(-1);
            break;
          }
          const std::string_view key(reinterpret_cast<const char *>(p),
                                     static_cast<size_t>(len));
          auto it = sv_find(c.intern, key);
          if (it == c.intern.end()) {
            it = c.intern
                     .emplace(std::string(key),
                              static_cast<int32_t>(c.distinct.size()))
                     .first;
            c.distinct.push_back(it->first);
          }
          c.i32.push_back(it->second);
          break;
        }
        case 'u':
        case 'b': {
          if (null) {
            c.text.push_back({0, -1});
            break;
          }
          c.text.push_back({c.arena.size(), len});
          c.arena.append(reinterpret_cast<const char *>(p),
                         static_cast<size_t>(len));
          break;
        }
        case 'o': {  // text passthrough (COPY binary carries no type tag)
          if (null) {
            c.tag.push_back(O_NULL);
            c.i64.push_back(0);
            c.f64.push_back(0.0);
            c.text.push_back({0, -1});
          } else {
            c.tag.push_back(O_TEXT);
            c.i64.push_back(0);
            c.f64.push_back(0.0);
            c.text.push_back({c.arena.size(), len});
            c.arena.append(reinterpret_cast<const char *>(p),
                           static_cast<size_t>(len));
          }
          break;
        }
      }
    }
  }
  return "";
}

// libpq COPY transport: run `sql` (a COPY ... TO STDOUT statement) and
// collect the whole binary stream.  Empty string on success.
std::string fetch_stream(const std::string &conninfo, const std::string &sql,
                         std::string &out) {
  PGconn *conn = PQconnectdb(conninfo.c_str());
  auto fail = [&](const std::string &msg) {
    std::string full = msg;
    if (conn) {
      full += ": ";
      full += PQerrorMessage(conn);
      PQfinish(conn);
    }
    return full;
  };
  if (!conn || PQstatus(conn) != CONNECTION_OK) return fail("connect failed");
  PGresult *res = PQexec(conn, sql.c_str());
  if (PQresultStatus(res) != PGRES_COPY_OUT) {
    std::string msg = PQresultErrorMessage(res);
    PQclear(res);
    return fail("COPY did not start: " + msg);
  }
  PQclear(res);
  char *buf = nullptr;
  int n;
  while ((n = PQgetCopyData(conn, &buf, 0)) > 0) {
    out.append(buf, static_cast<size_t>(n));
    PQfreemem(buf);
    buf = nullptr;
  }
  if (n == -2) return fail("COPY stream error");
  // Drain the command-completion result(s).
  bool ok = true;
  while ((res = PQgetResult(conn)) != nullptr) {
    const int st = PQresultStatus(res);
    if (st != PGRES_COMMAND_OK && st != PGRES_TUPLES_OK) ok = false;
    PQclear(res);
  }
  if (!ok) return fail("COPY did not complete cleanly");
  PQfinish(conn);
  return "";
}

// ---- Python entry points ---------------------------------------------------

PyObject *decode_cols(const std::string &spec, std::vector<Col> &cols) {
  PyObject *out = PyTuple_New(static_cast<Py_ssize_t>(cols.size()));
  if (!out) return nullptr;
  for (size_t i = 0; i < cols.size(); i++) {
    PyObject *arr = materialize(cols[i]);
    if (!arr) {
      Py_DECREF(out);
      return nullptr;
    }
    PyTuple_SET_ITEM(out, static_cast<Py_ssize_t>(i), arr);
  }
  return out;
}

bool init_cols(const char *spec_c, std::vector<Col> &cols) {
  const std::string spec(spec_c);
  cols.resize(spec.size());
  for (size_t i = 0; i < spec.size(); i++) {
    cols[i].spec = spec[i];
    if (!strchr("ptfscubo", spec[i])) {
      err("unknown spec char");
      return false;
    }
  }
  return true;
}

// parse_copy_binary(data: bytes, spec, key_values) -> tuple of arrays.
// The server-independent half — unit-tested on crafted streams.
PyObject *parse_copy_binary(PyObject *, PyObject *args) {
  const char *spec_c;
  PyObject *data_o, *keys_o;
  if (!PyArg_ParseTuple(args, "SsO", &data_o, &spec_c, &keys_o))
    return nullptr;
  std::vector<Col> cols;
  if (!init_cols(spec_c, cols)) return nullptr;
  SvMap keymap;
  if (!build_keymap(keys_o, keymap)) return nullptr;
  const uint8_t *data = reinterpret_cast<const uint8_t *>(
      PyBytes_AS_STRING(data_o));
  const size_t size = static_cast<size_t>(PyBytes_GET_SIZE(data_o));
  std::string e;
  Py_BEGIN_ALLOW_THREADS;
  e = parse_stream(data, size, keymap, cols);
  Py_END_ALLOW_THREADS;
  if (!e.empty()) return err(e);
  return decode_cols(spec_c, cols);
}

// fetch_table_pg(conninfo, copy_sql, spec, key_values) -> tuple of arrays.
PyObject *fetch_table_pg(PyObject *, PyObject *args) {
  const char *conninfo_c, *sql_c, *spec_c;
  PyObject *keys_o;
  if (!PyArg_ParseTuple(args, "sssO", &conninfo_c, &sql_c, &spec_c, &keys_o))
    return nullptr;
  std::vector<Col> cols;
  if (!init_cols(spec_c, cols)) return nullptr;
  SvMap keymap;
  if (!build_keymap(keys_o, keymap)) return nullptr;
  std::string stream, e;
  Py_BEGIN_ALLOW_THREADS;
  e = fetch_stream(conninfo_c, sql_c, stream);
  if (e.empty())
    e = parse_stream(reinterpret_cast<const uint8_t *>(stream.data()),
                     stream.size(), keymap, cols);
  Py_END_ALLOW_THREADS;
  if (!e.empty()) return err(e);
  return decode_cols(spec_c, cols);
}

PyMethodDef methods[] = {
    {"parse_copy_binary", parse_copy_binary, METH_VARARGS,
     "parse_copy_binary(data, spec, key_values) -> tuple of numpy arrays"},
    {"fetch_table_pg", fetch_table_pg, METH_VARARGS,
     "fetch_table_pg(conninfo, copy_sql, spec, key_values) -> tuple of "
     "numpy arrays"},
    {nullptr, nullptr, 0, nullptr}};

struct PyModuleDef moddef = {PyModuleDef_HEAD_INIT, "_tse1m_torch_pgdecode",
                             "Postgres COPY-binary -> numpy bulk decoder",
                             -1, methods, nullptr, nullptr, nullptr,
                             nullptr};

}  // namespace

PyMODINIT_FUNC PyInit__tse1m_torch_pgdecode(void) {
  import_array();
  return PyModule_Create(&moddef);
}
