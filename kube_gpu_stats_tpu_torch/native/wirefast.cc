// _wirefast: the host fast paths of the H100 hub and exporter, in one
// CPython extension.
//
// Each function computes exactly what a Python path of the package
// computes, which stays beside it as its oracle:
//
//   apply_slots         hub._TargetCache's per-slot delta patch loop
//   snappy_uncompress   snappy._decompress_py
//   decode_delta_slots  the slot walk of delta.decode_frame_raw
//   decode_delta_frame  the whole common-case DELTA decode of it
//   render_exposition   registry.Snapshot.render(...).encode()
//   gzip_compress       gzip.compress(data, compresslevel, mtime=0)
//   fold_rows           the hub's ChipRow.clone_at frame-fold loop
//
// Bytes are equal and floats bitwise equal; tests/test_torch_native.py
// holds every function against its oracle. gzip_compress writes the
// 10-byte header that the running interpreter's gzip.compress writes
// (configure_gzip), so it matches whichever Python loads it.
//
// Build: kube_gpu_stats_tpu_torch/native/_hostbuild.py (g++ -O2 -fPIC
// -std=c++17 -shared, Python's include directory, -lz), at first use.

#define PY_SSIZE_T_CLEAN
#include <Python.h>

#include <zlib.h>

#include <cmath>
#include <cstdint>
#include <cstring>
#include <string>
#include <vector>

namespace {

PyObject* err(const char* msg) {
  PyErr_SetString(PyExc_ValueError, msg);
  return nullptr;
}

// --- hub delta-ingest batch apply -----------------------------------------
//
// apply_slots(entry, slots, values) runs the hub's _TargetCache
// per-slot patch loop in one C call: store each value into the entry's
// float slab, rebuild the series/dict view tuples (names and label
// objects are reused — only the value leaf changes), rebuild the
// chip/rollup merge-plan pairs the slot feeds, and patch the cached
// frame fold (ChipRow column setattr / ICI delta accumulate / rollup
// cell store). Semantics are pinned byte-identical to
// _TargetCache.apply_patch (the Python oracle, kept behind
// --no-native-ingest) by tests/test_torch_native.py.
//
// The per-slot dispatch comes from the entry's compiled patch program
// (hub._TargetCache._compile_program): kind byte, chip/rollup pair
// index, fold key, row column — the kind values below MUST stay in
// sync with hub._PATCH_* (pinned by the differential suite).

constexpr int kPatchPlain = 0;
constexpr int kPatchRow = 1;
constexpr int kPatchIci = 2;
constexpr int kPatchRollup = 3;
constexpr int kPatchHist = 4;
constexpr int kPatchDigest = 5;

// Invalidation flags returned to Python (applied to the entry there so
// this function never mutates attributes mid-loop).
constexpr long kFlagHist = 1;
constexpr long kFlagDigest = 2;
constexpr long kFlagRowsInvalid = 4;

PyObject* g_series_cls = nullptr;  // registry.Series (owned)
PyObject* g_s_ici_bps = nullptr;   // "ici_bps"
// Entry attribute names, interned once.
PyObject* g_a_series = nullptr;
PyObject* g_a_series_dicts = nullptr;
PyObject* g_a_chip_plan = nullptr;
PyObject* g_a_rollup_plan = nullptr;
PyObject* g_a_frame_rows = nullptr;
PyObject* g_a_frame_rollups = nullptr;
PyObject* g_a_patch_program = nullptr;
PyObject* g_a_value_slab = nullptr;

PyObject* py_configure_apply(PyObject*, PyObject* args) {
  PyObject* series_cls;
  if (!PyArg_ParseTuple(args, "O", &series_cls)) return nullptr;
  if (!PyType_Check(series_cls))
    return err("configure_apply expects the Series class");
  Py_XSETREF(g_series_cls, series_cls);
  Py_INCREF(series_cls);
  Py_RETURN_NONE;
}

// Series(spec, labels, value) without the NamedTuple's Python-level
// __new__ (which dominates the per-pair cost): registry.Series is a
// tuple subclass whose generated __new__ is exactly tuple.__new__(cls,
// (spec, labels, value)), so calling tuple's tp_new on the subtype is
// semantically identical and stays in C.
PyObject* make_series(PyObject* spec, PyObject* labels, PyObject* fval) {
  PyObject* inner = PyTuple_Pack(3, spec, labels, fval);
  if (!inner) return nullptr;
  PyObject* args = PyTuple_Pack(1, inner);
  Py_DECREF(inner);
  if (!args) return nullptr;
  PyObject* out =
      PyTuple_Type.tp_new((PyTypeObject*)g_series_cls, args, nullptr);
  Py_DECREF(args);
  return out;
}

// Replace pairs[index] = (key, Series(spec, labels, value)) keeping the
// key/spec/labels objects of the old pair. Returns 0/-1.
int rebuild_pair(PyObject* pairs, int index, PyObject* fval) {
  if (!PyList_Check(pairs) || index >= PyList_GET_SIZE(pairs)) {
    PyErr_SetString(PyExc_ValueError, "patch program pair index invalid");
    return -1;
  }
  PyObject* pair = PyList_GET_ITEM(pairs, index);
  PyObject* key = PyTuple_GET_ITEM(pair, 0);
  PyObject* old_series = PyTuple_GET_ITEM(pair, 1);
  PyObject* new_series =
      make_series(PyTuple_GET_ITEM(old_series, 0),
                  PyTuple_GET_ITEM(old_series, 1), fval);
  if (!new_series) return -1;
  PyObject* new_pair = PyTuple_Pack(2, key, new_series);
  Py_DECREF(new_series);
  if (!new_pair) return -1;
  PyList_SetItem(pairs, index, new_pair);  // steals new_pair
  return 0;
}

// Replace views[slot] = (item0, item1, value) keeping items 0/1.
int rebuild_triple(PyObject* views, Py_ssize_t slot, PyObject* fval) {
  PyObject* old_t = PyList_GET_ITEM(views, slot);
  PyObject* new_t = PyTuple_Pack(3, PyTuple_GET_ITEM(old_t, 0),
                                 PyTuple_GET_ITEM(old_t, 1), fval);
  if (!new_t) return -1;
  PyList_SetItem(views, slot, new_t);  // steals
  return 0;
}

PyObject* py_apply_slots(PyObject*, PyObject* args) {
  PyObject* entry;
  PyObject* slots;
  PyObject* values;
  if (!PyArg_ParseTuple(args, "OO!O!", &entry, &PyTuple_Type, &slots,
                        &PyTuple_Type, &values))
    return nullptr;
  if (!g_series_cls)
    return err("configure_apply() has not been called");
  Py_ssize_t count = PyTuple_GET_SIZE(slots);
  if (PyTuple_GET_SIZE(values) != count)
    return err("slots/values length mismatch");

  PyObject* series = nullptr;
  PyObject* dicts = nullptr;
  PyObject* chip_plan = nullptr;
  PyObject* rollup_plan = nullptr;
  PyObject* frame_rows = nullptr;
  PyObject* frame_rollups = nullptr;
  PyObject* program = nullptr;
  PyObject* slab_obj = nullptr;
  Py_buffer slab_buf = {};
  bool slab_held = false;
  PyObject* result = nullptr;
  long flags = 0;

  series = PyObject_GetAttr(entry, g_a_series);
  dicts = series ? PyObject_GetAttr(entry, g_a_series_dicts) : nullptr;
  chip_plan = dicts ? PyObject_GetAttr(entry, g_a_chip_plan) : nullptr;
  rollup_plan =
      chip_plan ? PyObject_GetAttr(entry, g_a_rollup_plan) : nullptr;
  frame_rows =
      rollup_plan ? PyObject_GetAttr(entry, g_a_frame_rows) : nullptr;
  frame_rollups =
      frame_rows ? PyObject_GetAttr(entry, g_a_frame_rollups) : nullptr;
  program =
      frame_rollups ? PyObject_GetAttr(entry, g_a_patch_program) : nullptr;
  slab_obj = program ? PyObject_GetAttr(entry, g_a_value_slab) : nullptr;
  if (!slab_obj) goto done;

  {
    if (!PyList_Check(series) || !PyList_Check(dicts)) {
      err("entry series views must be lists");
      goto done;
    }
    if (!PyTuple_Check(program) || PyTuple_GET_SIZE(program) != 5) {
      err("entry has no compiled patch program");
      goto done;
    }
    PyObject* kinds_obj = PyTuple_GET_ITEM(program, 0);
    PyObject* chip_idx_obj = PyTuple_GET_ITEM(program, 1);
    PyObject* rollup_idx_obj = PyTuple_GET_ITEM(program, 2);
    PyObject* keys = PyTuple_GET_ITEM(program, 3);
    PyObject* cols = PyTuple_GET_ITEM(program, 4);
    if (!PyBytes_Check(kinds_obj) || !PyBytes_Check(chip_idx_obj) ||
        !PyBytes_Check(rollup_idx_obj) || !PyTuple_Check(keys) ||
        !PyTuple_Check(cols)) {
      err("malformed patch program");
      goto done;
    }
    if (PyObject_GetBuffer(slab_obj, &slab_buf, PyBUF_WRITABLE) < 0)
      goto done;
    slab_held = true;

    Py_ssize_t n_slots = PyList_GET_SIZE(series);
    const uint8_t* kinds = (const uint8_t*)PyBytes_AS_STRING(kinds_obj);
    const int32_t* chip_idx =
        (const int32_t*)PyBytes_AS_STRING(chip_idx_obj);
    const int32_t* rollup_idx =
        (const int32_t*)PyBytes_AS_STRING(rollup_idx_obj);
    double* slab = (double*)slab_buf.buf;
    if (PyBytes_GET_SIZE(kinds_obj) != n_slots ||
        PyBytes_GET_SIZE(chip_idx_obj) !=
            (Py_ssize_t)(n_slots * sizeof(int32_t)) ||
        PyBytes_GET_SIZE(rollup_idx_obj) !=
            (Py_ssize_t)(n_slots * sizeof(int32_t)) ||
        slab_buf.len != (Py_ssize_t)(n_slots * sizeof(double)) ||
        PyList_GET_SIZE(dicts) != n_slots ||
        PyTuple_GET_SIZE(keys) != n_slots ||
        PyTuple_GET_SIZE(cols) != n_slots) {
      err("patch program does not match the entry shape");
      goto done;
    }
    PyObject* chip_pairs =
        (chip_plan != Py_None && PyTuple_Check(chip_plan) &&
         PyTuple_GET_SIZE(chip_plan) >= 2)
            ? PyTuple_GET_ITEM(chip_plan, 1)
            : nullptr;
    PyObject* rollup_pairs =
        (rollup_plan != Py_None && PyTuple_Check(rollup_plan) &&
         PyTuple_GET_SIZE(rollup_plan) >= 2)
            ? PyTuple_GET_ITEM(rollup_plan, 1)
            : nullptr;
    // Mirror the Python loop's mid-frame invalidation: once a fold key
    // misses its row, BOTH fold caches stop taking patches for the
    // rest of the frame (they are refolded lazily at the next refresh).
    bool rows_valid = true;
    bool rollups_valid = true;

    for (Py_ssize_t i = 0; i < count; ++i) {
      Py_ssize_t slot = PyLong_AsSsize_t(PyTuple_GET_ITEM(slots, i));
      if (slot == -1 && PyErr_Occurred()) goto done;
      if (slot < 0 || slot >= n_slots) {
        err("slot out of range for the compiled program");
        goto done;
      }
      double value = PyFloat_AsDouble(PyTuple_GET_ITEM(values, i));
      if (value == -1.0 && PyErr_Occurred()) goto done;
      double old = slab[slot];
      slab[slot] = value;
      PyObject* fval = PyFloat_FromDouble(value);
      if (!fval) goto done;
      int rc = rebuild_triple(series, slot, fval);
      if (rc == 0) rc = rebuild_triple(dicts, slot, fval);
      int ci = chip_idx[slot];
      if (rc == 0 && ci >= 0 && chip_pairs)
        rc = rebuild_pair(chip_pairs, ci, fval);
      int ri = rollup_idx[slot];
      if (rc == 0 && ri >= 0 && rollup_pairs)
        rc = rebuild_pair(rollup_pairs, ri, fval);
      if (rc != 0) {
        Py_DECREF(fval);
        goto done;
      }
      int kind = kinds[slot];
      if (kind == kPatchHist) {
        flags |= kFlagHist;
      } else if (kind == kPatchDigest) {
        flags |= kFlagDigest;
      } else if (kind == kPatchRollup) {
        if (rollups_valid && frame_rollups != Py_None) {
          if (PyDict_SetItem(frame_rollups, PyTuple_GET_ITEM(keys, slot),
                             fval) < 0) {
            Py_DECREF(fval);
            goto done;
          }
        }
      } else if (kind == kPatchRow || kind == kPatchIci) {
        if (rows_valid && frame_rows != Py_None) {
          PyObject* row =
              PyDict_GetItem(frame_rows, PyTuple_GET_ITEM(keys, slot));
          if (!row) {
            if (PyErr_Occurred()) {
              Py_DECREF(fval);
              goto done;
            }
            // Fold/series shape disagreement: refold lazily (oracle
            // sets frame_rows/frame_rollups to None here).
            rows_valid = false;
            rollups_valid = false;
            flags |= kFlagRowsInvalid;
          } else if (kind == kPatchIci) {
            PyObject* cur = PyObject_GetAttr(row, g_s_ici_bps);
            if (!cur) {
              Py_DECREF(fval);
              goto done;
            }
            double accumulated = PyFloat_AsDouble(cur);
            Py_DECREF(cur);
            if (accumulated == -1.0 && PyErr_Occurred()) {
              Py_DECREF(fval);
              goto done;
            }
            PyObject* next =
                PyFloat_FromDouble(accumulated + (value - old));
            if (!next || PyObject_SetAttr(row, g_s_ici_bps, next) < 0) {
              Py_XDECREF(next);
              Py_DECREF(fval);
              goto done;
            }
            Py_DECREF(next);
          } else {
            if (PyObject_SetAttr(row, PyTuple_GET_ITEM(cols, slot),
                                 fval) < 0) {
              Py_DECREF(fval);
              goto done;
            }
          }
        }
      }
      Py_DECREF(fval);
    }
    result = PyLong_FromLong(flags);
  }

done:
  if (slab_held) PyBuffer_Release(&slab_buf);
  Py_XDECREF(slab_obj);
  Py_XDECREF(program);
  Py_XDECREF(frame_rollups);
  Py_XDECREF(frame_rows);
  Py_XDECREF(rollup_plan);
  Py_XDECREF(chip_plan);
  Py_XDECREF(dicts);
  Py_XDECREF(series);
  return result;
}

// --- snappy block decompress -----------------------------------------------
//
// Byte-for-byte the semantics (and error messages) of
// kube_gpu_stats_tpu_torch/snappy.py decompress(), which stays as the
// fallback and the readable reference. The pure-Python decoder builds
// its output a byte at a time — at 10k-pusher ingest fan-in that was
// the hottest line of the whole handle() path.

PyObject* py_snappy_uncompress(PyObject*, PyObject* args) {
  Py_buffer buf;
  if (!PyArg_ParseTuple(args, "y*", &buf)) return nullptr;
  const uint8_t* data = (const uint8_t*)buf.buf;
  Py_ssize_t n = buf.len;
  PyObject* out_obj = nullptr;
  uint64_t expected = 0;
  int shift = 0;
  Py_ssize_t pos = 0;
  uint64_t out_len = 0;
  uint8_t* out = nullptr;

  for (;;) {
    if (pos >= n) {
      err("truncated snappy preamble");
      goto fail;
    }
    uint8_t byte = data[pos++];
    expected |= (uint64_t)(byte & 0x7F) << shift;
    if (!(byte & 0x80)) break;
    shift += 7;
    if (shift > 32) {
      err("snappy length varint too long");
      goto fail;
    }
  }
  // This decoder allocates the declared size upfront, so bound it
  // (callers with hostile input — the delta ingest — already reject
  // large preambles before any decompression; this cap just keeps a
  // bare decompress() call from attempting a multi-GB allocation).
  // The Python reference applies the SAME cap with the SAME message,
  // preserving the byte-for-byte error-verdict equivalence the
  // differential suite pins.
  if (expected > ((uint64_t)1 << 31)) {
    err("snappy declared length too large");
    goto fail;
  }
  out_obj = PyBytes_FromStringAndSize(nullptr, (Py_ssize_t)expected);
  if (!out_obj) goto fail;
  out = (uint8_t*)PyBytes_AS_STRING(out_obj);

  while (pos < n) {
    uint8_t tag = data[pos++];
    int kind = tag & 0b11;
    if (kind == 0b00) {  // literal
      uint64_t length = tag >> 2;
      if (length >= 60) {
        int extra = (int)length - 59;  // 60..63 -> 1..4 length bytes
        if (pos + extra > n) {
          err("truncated literal length");
          goto fail;
        }
        length = 0;
        for (int i = 0; i < extra; ++i)
          length |= (uint64_t)data[pos + i] << (8 * i);
        pos += extra;
      }
      length += 1;
      if ((uint64_t)(n - pos) < length) {
        err("truncated literal body");
        goto fail;
      }
      if (out_len + length > expected) {
        err("snappy output exceeds declared length");
        goto fail;
      }
      memcpy(out + out_len, data + pos, length);
      out_len += length;
      pos += (Py_ssize_t)length;
      continue;
    }
    uint64_t length;
    uint32_t offset;
    if (kind == 0b01) {  // copy, 1-byte offset
      length = ((tag >> 2) & 0x07) + 4;
      if (pos >= n) {
        err("truncated copy-1 offset");
        goto fail;
      }
      offset = ((uint32_t)(tag >> 5) << 8) | data[pos];
      pos += 1;
    } else if (kind == 0b10) {  // copy, 2-byte offset
      length = (tag >> 2) + 1;
      if (pos + 2 > n) {
        err("truncated copy-2 offset");
        goto fail;
      }
      offset = (uint32_t)data[pos] | ((uint32_t)data[pos + 1] << 8);
      pos += 2;
    } else {  // copy, 4-byte offset
      length = (tag >> 2) + 1;
      if (pos + 4 > n) {
        err("truncated copy-4 offset");
        goto fail;
      }
      offset = (uint32_t)data[pos] | ((uint32_t)data[pos + 1] << 8) |
               ((uint32_t)data[pos + 2] << 16) |
               ((uint32_t)data[pos + 3] << 24);
      pos += 4;
    }
    if (offset == 0 || offset > out_len) {
      err("copy offset out of range");
      goto fail;
    }
    if (out_len + length > expected) {
      err("snappy output exceeds declared length");
      goto fail;
    }
    // Copies may overlap their own output (RLE-style); byte-by-byte
    // semantics are the spec'd behavior.
    uint64_t start = out_len - offset;
    for (uint64_t i = 0; i < length; ++i) out[out_len + i] = out[start + i];
    out_len += length;
  }
  if (out_len != expected) {
    PyErr_Format(PyExc_ValueError,
                 "snappy length mismatch: preamble %llu, got %llu",
                 (unsigned long long)expected, (unsigned long long)out_len);
    goto fail;
  }
  PyBuffer_Release(&buf);
  return out_obj;

fail:
  PyBuffer_Release(&buf);
  Py_XDECREF(out_obj);
  return nullptr;
}

// ---------------------------------------------------------------------------
// Delta-frame slot decode, exposition render +
// gzip, and the hub frame-fold loop. Each mirrors a pure-Python oracle
// (delta.decode_frame_raw's inlined loop, registry.Snapshot.render,
// gzip.compress(mtime=0), top.ChipRow.clone_at) byte-for-byte / object-for-
// object; tests/test_torch_native.py pins the equivalence.

PyObject* g_a_name = nullptr;     // "name"
PyObject* g_a_help = nullptr;     // "help"
PyObject* g_a_spec = nullptr;     // "spec"
PyObject* g_a_buckets = nullptr;  // "buckets"
PyObject* g_a_counts = nullptr;   // "counts"
PyObject* g_a_total = nullptr;    // "total"
PyObject* g_a_sum = nullptr;      // "sum"
PyObject* g_a_labels = nullptr;   // "labels"
PyObject* g_a_at = nullptr;       // "at"
PyObject* g_a_dict = nullptr;     // "__dict__"
PyObject* g_empty_tuple = nullptr;

// decode_delta_slots(data, pos, count) -> (slots, values, end) | None.
// Exact semantics (including error strings) of the inlined varint walk in
// delta.decode_frame_raw. Returns None — caller falls back to the Python
// loop — when an adversarial frame would push a slot index past 2^62,
// where Python's unbounded ints and C's fixed words part ways.
PyObject* py_decode_delta_slots(PyObject*, PyObject* args) {
  Py_buffer buf;
  Py_ssize_t pos, count;
  if (!PyArg_ParseTuple(args, "y*nn", &buf, &pos, &count)) return nullptr;
  const uint8_t* data = (const uint8_t*)buf.buf;
  const Py_ssize_t n = buf.len;
  std::vector<int64_t> slots;
  std::vector<double> values;
  if (count > 0 && count < (Py_ssize_t)1 << 22) {
    slots.reserve(count);
    values.reserve(count);
  }
  int64_t slot = 0;
  constexpr int64_t kSlotCap = (int64_t)1 << 62;
  for (Py_ssize_t i = 0; i < count; ++i) {
    if (pos >= n) {
      PyBuffer_Release(&buf);
      return err("truncated varint");
    }
    uint64_t byte = data[pos++];
    uint64_t gap;
    if (byte < 0x80) {
      gap = byte;
    } else {
      gap = byte & 0x7F;
      int shift = 7;
      for (;;) {
        if (pos >= n) {
          PyBuffer_Release(&buf);
          return err("truncated varint");
        }
        byte = data[pos++];
        gap |= (uint64_t)(byte & 0x7F) << shift;
        if (!(byte & 0x80)) break;
        shift += 7;
        if (shift > 63) {
          PyBuffer_Release(&buf);
          return err("varint too long");
        }
      }
    }
    if (gap >= (uint64_t)kSlotCap || slot + (int64_t)gap >= kSlotCap) {
      PyBuffer_Release(&buf);
      Py_RETURN_NONE;  // caller re-runs the exact-arithmetic Python loop
    }
    slot += (int64_t)gap;
    if (pos + 8 > n) {
      PyBuffer_Release(&buf);
      return err("truncated delta value");
    }
    double v;
    memcpy(&v, data + pos, 8);  // little-endian float64, matches _F64
    pos += 8;
    slots.push_back(slot);
    values.push_back(v);
  }
  PyBuffer_Release(&buf);
  const Py_ssize_t m = (Py_ssize_t)slots.size();
  PyObject* slots_t = PyTuple_New(m);
  PyObject* values_t = slots_t ? PyTuple_New(m) : nullptr;
  if (!values_t) {
    Py_XDECREF(slots_t);
    return nullptr;
  }
  for (Py_ssize_t i = 0; i < m; ++i) {
    PyObject* so = PyLong_FromLongLong(slots[i]);
    PyObject* vo = so ? PyFloat_FromDouble(values[i]) : nullptr;
    if (!vo) {
      Py_XDECREF(so);
      Py_DECREF(slots_t);
      Py_DECREF(values_t);
      return nullptr;
    }
    PyTuple_SET_ITEM(slots_t, i, so);
    PyTuple_SET_ITEM(values_t, i, vo);
  }
  PyObject* out = PyTuple_New(3);
  if (!out) {
    Py_DECREF(slots_t);
    Py_DECREF(values_t);
    return nullptr;
  }
  PyTuple_SET_ITEM(out, 0, slots_t);
  PyTuple_SET_ITEM(out, 1, values_t);
  PyObject* pos_obj = PyLong_FromSsize_t(pos);
  if (!pos_obj) {
    Py_DECREF(out);
    return nullptr;
  }
  PyTuple_SET_ITEM(out, 2, pos_obj);
  return out;
}

// Bounded-varint read for the whole-frame decode below: false on
// truncation, over-long encodings, or values past uint64 (Python's
// unbounded ints accept up to ~70 bits before "varint too long" — those
// frames fall back to the oracle).
bool read_varint64(const uint8_t* data, Py_ssize_t n, Py_ssize_t* pos,
                   uint64_t* out) {
  uint64_t value = 0;
  int shift = 0;
  for (;;) {
    if (*pos >= n) return false;
    uint64_t byte = data[(*pos)++];
    if (shift == 63 && (byte & 0x7F) > 1) return false;  // > uint64
    value |= (byte & 0x7F) << shift;
    if (!(byte & 0x80)) {
      *out = value;
      return true;
    }
    shift += 7;
    if (shift > 63) return false;  // Python raises "varint too long"
  }
}

// decode_delta_frame(data) -> (source, generation, seq, slots, values,
// proto, caps, build) | None. The complete common-case DELTA decode —
// header, source, slot walk, v2 extension walk, trailing-bytes check —
// in one C call (delta.decode_frame_raw's per-frame Python dispatch was
// a visible slice of the 10k-pusher storm after the slot walk went
// native). None for ANYTHING unusual: bad magic, FULL frames, skewed
// protos, malformed/truncated bytes, slots past 2^62, gen/seq/caps past
// uint64 — the caller falls back to the Python oracle, which owns every
// error string and the FrameVersionSkew verdict. The differential fuzz
// in tests/test_torch_native.py pins the equivalence.
PyObject* py_decode_delta_frame(PyObject*, PyObject* args) {
  Py_buffer buf;
  if (!PyArg_ParseTuple(args, "y*", &buf)) return nullptr;
  const uint8_t* data = (const uint8_t*)buf.buf;
  const Py_ssize_t n = buf.len;
  constexpr uint8_t kKindDelta = 1;      // delta.KIND_DELTA
  constexpr uint8_t kProtoMin = 1, kProtoMax = 2;
  constexpr uint64_t kExtBuild = 1;      // delta.EXT_BUILD
  constexpr int64_t kSlotCap = (int64_t)1 << 62;

  PyObject* source = nullptr;
  PyObject* build = nullptr;
  bool fallback = true;
  Py_ssize_t pos = 6;
  uint8_t proto = 0;
  uint64_t caps = 0, generation = 0, seq = 0, count = 0;
  std::vector<int64_t> slots;
  std::vector<double> values;
  do {
    if (n < 6 || memcmp(data, "KTSD", 4) != 0) break;
    proto = data[4];
    if (proto < kProtoMin || proto > kProtoMax) break;
    if (data[5] != kKindDelta) break;
    if (proto >= 2 && !read_varint64(data, n, &pos, &caps)) break;
    uint64_t srclen;
    if (!read_varint64(data, n, &pos, &srclen)) break;
    if (srclen == 0 || (uint64_t)(n - pos) < srclen) break;
    source = PyUnicode_DecodeUTF8((const char*)data + pos,
                                  (Py_ssize_t)srclen, nullptr);
    if (!source) {
      PyErr_Clear();  // invalid UTF-8: the oracle raises the verdict
      break;
    }
    pos += (Py_ssize_t)srclen;
    if (!read_varint64(data, n, &pos, &generation)) break;
    if (!read_varint64(data, n, &pos, &seq)) break;
    if (!read_varint64(data, n, &pos, &count)) break;
    if (count > (uint64_t)1 << 22) break;  // adversarial count: oracle
    slots.reserve(count);
    values.reserve(count);
    int64_t slot = 0;
    bool bad = false;
    for (uint64_t i = 0; i < count && !bad; ++i) {
      uint64_t gap;
      if (!read_varint64(data, n, &pos, &gap)) {
        bad = true;
        break;
      }
      if (gap >= (uint64_t)kSlotCap || slot + (int64_t)gap >= kSlotCap) {
        bad = true;  // unbounded-int arithmetic: oracle
        break;
      }
      slot += (int64_t)gap;
      if (pos + 8 > n) {
        bad = true;
        break;
      }
      double v;
      memcpy(&v, data + pos, 8);  // little-endian float64, matches _F64
      pos += 8;
      slots.push_back(slot);
      values.push_back(v);
    }
    if (bad) break;
    if (proto >= 2) {
      // Trailing extension walk (delta._read_exts): unknown tags
      // skipped whole; a later duplicate EXT_BUILD wins, like the
      // oracle's overwrite.
      bool ext_bad = false;
      while (pos < n) {
        uint64_t tag, length;
        if (!read_varint64(data, n, &pos, &tag) ||
            !read_varint64(data, n, &pos, &length) ||
            (uint64_t)(n - pos) < length) {
          ext_bad = true;
          break;
        }
        if (tag == kExtBuild) {
          Py_XDECREF(build);
          build = PyUnicode_DecodeUTF8((const char*)data + pos,
                                       (Py_ssize_t)length, nullptr);
          if (!build) {
            PyErr_Clear();
            ext_bad = true;
            break;
          }
        }
        pos += (Py_ssize_t)length;
      }
      if (ext_bad) break;
    }
    if (pos != n) break;  // "trailing bytes after delta changes": oracle
    fallback = false;
  } while (false);
  PyBuffer_Release(&buf);
  if (fallback) {
    Py_XDECREF(source);
    Py_XDECREF(build);
    Py_RETURN_NONE;
  }
  const Py_ssize_t m = (Py_ssize_t)slots.size();
  PyObject* slots_t = PyTuple_New(m);
  PyObject* values_t = slots_t ? PyTuple_New(m) : nullptr;
  if (!values_t) {
    Py_XDECREF(slots_t);
    Py_DECREF(source);
    Py_XDECREF(build);
    return nullptr;
  }
  for (Py_ssize_t i = 0; i < m; ++i) {
    PyObject* so = PyLong_FromLongLong(slots[i]);
    PyObject* vo = so ? PyFloat_FromDouble(values[i]) : nullptr;
    if (!vo) {
      Py_XDECREF(so);
      Py_DECREF(slots_t);
      Py_DECREF(values_t);
      Py_DECREF(source);
      Py_XDECREF(build);
      return nullptr;
    }
    PyTuple_SET_ITEM(slots_t, i, so);
    PyTuple_SET_ITEM(values_t, i, vo);
  }
  if (!build) build = PyUnicode_FromStringAndSize("", 0);
  PyObject* gen_o = build ? PyLong_FromUnsignedLongLong(generation)
                          : nullptr;
  PyObject* seq_o = gen_o ? PyLong_FromUnsignedLongLong(seq) : nullptr;
  PyObject* proto_o = seq_o ? PyLong_FromLong(proto) : nullptr;
  PyObject* caps_o = proto_o ? PyLong_FromUnsignedLongLong(caps)
                             : nullptr;
  PyObject* out = caps_o ? PyTuple_New(8) : nullptr;
  if (!out) {
    Py_XDECREF(gen_o);
    Py_XDECREF(seq_o);
    Py_XDECREF(proto_o);
    Py_XDECREF(caps_o);
    Py_DECREF(slots_t);
    Py_DECREF(values_t);
    Py_DECREF(source);
    Py_XDECREF(build);
    return nullptr;
  }
  PyTuple_SET_ITEM(out, 0, source);
  PyTuple_SET_ITEM(out, 1, gen_o);
  PyTuple_SET_ITEM(out, 2, seq_o);
  PyTuple_SET_ITEM(out, 3, slots_t);
  PyTuple_SET_ITEM(out, 4, values_t);
  PyTuple_SET_ITEM(out, 5, proto_o);
  PyTuple_SET_ITEM(out, 6, caps_o);
  PyTuple_SET_ITEM(out, 7, build);
  return out;
}

// configure_render() state: the non-histogram metric families in schema
// order, each with prejoined HELP/TYPE header bytes for both formats.
struct RenderFamily {
  PyObject* name;    // owned str (the grouping key, == spec.name)
  PyObject* plain;   // owned bytes "# HELP ...\n# TYPE ...\n"
  PyObject* om;      // owned bytes, OpenMetrics variant
  std::string utf8;  // spec.name as UTF-8 for direct line assembly
};
std::vector<RenderFamily>* g_render_families = nullptr;

PyObject* py_configure_render(PyObject*, PyObject* args) {
  PyObject* fams;
  if (!PyArg_ParseTuple(args, "O!", &PyTuple_Type, &fams)) return nullptr;
  auto* parsed = new std::vector<RenderFamily>();
  for (Py_ssize_t i = 0; i < PyTuple_GET_SIZE(fams); ++i) {
    PyObject* item = PyTuple_GET_ITEM(fams, i);
    if (!PyTuple_Check(item) || PyTuple_GET_SIZE(item) != 3 ||
        !PyUnicode_Check(PyTuple_GET_ITEM(item, 0)) ||
        !PyBytes_Check(PyTuple_GET_ITEM(item, 1)) ||
        !PyBytes_Check(PyTuple_GET_ITEM(item, 2))) {
      delete parsed;
      return err("configure_render expects ((name, plain, om), ...)");
    }
    Py_ssize_t len = 0;
    const char* utf8 =
        PyUnicode_AsUTF8AndSize(PyTuple_GET_ITEM(item, 0), &len);
    if (!utf8) {
      delete parsed;
      return nullptr;
    }
    RenderFamily fam;
    fam.name = PyTuple_GET_ITEM(item, 0);
    fam.plain = PyTuple_GET_ITEM(item, 1);
    fam.om = PyTuple_GET_ITEM(item, 2);
    Py_INCREF(fam.name);
    Py_INCREF(fam.plain);
    Py_INCREF(fam.om);
    fam.utf8.assign(utf8, (size_t)len);
    parsed->push_back(fam);
  }
  if (g_render_families) {
    for (auto& fam : *g_render_families) {
      Py_DECREF(fam.name);
      Py_DECREF(fam.plain);
      Py_DECREF(fam.om);
    }
    delete g_render_families;
  }
  g_render_families = parsed;
  Py_RETURN_NONE;
}

void append_escaped(std::string& out, const char* s, Py_ssize_t len) {
  for (Py_ssize_t i = 0; i < len; ++i) {
    const char c = s[i];
    if (c == '\\')
      out += "\\\\";
    else if (c == '"')
      out += "\\\"";
    else if (c == '\n')
      out += "\\n";
    else
      out += c;
  }
}

// Append one k="v" pair (escaped); false + exception on a non-str pair.
bool append_label_pair(std::string& out, PyObject* pair) {
  if (!PyTuple_Check(pair) || PyTuple_GET_SIZE(pair) != 2) {
    err("label pair is not a 2-tuple");
    return false;
  }
  Py_ssize_t klen = 0, vlen = 0;
  const char* k = PyUnicode_AsUTF8AndSize(PyTuple_GET_ITEM(pair, 0), &klen);
  if (!k) return false;
  const char* v = PyUnicode_AsUTF8AndSize(PyTuple_GET_ITEM(pair, 1), &vlen);
  if (!v) return false;
  out.append(k, (size_t)klen);
  out += "=\"";
  append_escaped(out, v, vlen);
  out += '"';
  return true;
}

// schema.render_labels: "{k="v",...}" or "" for an empty tuple.
bool append_labels(std::string& out, PyObject* labels) {
  if (!PyTuple_Check(labels)) {
    err("labels is not a tuple");
    return false;
  }
  const Py_ssize_t n = PyTuple_GET_SIZE(labels);
  if (n == 0) return true;
  out += '{';
  for (Py_ssize_t i = 0; i < n; ++i) {
    if (i) out += ',';
    if (!append_label_pair(out, PyTuple_GET_ITEM(labels, i))) return false;
  }
  out += '}';
  return true;
}

// registry.format_value: NaN/±Inf words, int-collapse under 1e15, else
// CPython float repr (PyOS_double_to_string is exactly float.__repr__).
bool append_value(std::string& out, double v) {
  if (std::isnan(v)) {
    out += "NaN";
    return true;
  }
  if (std::isinf(v)) {
    out += v > 0 ? "+Inf" : "-Inf";
    return true;
  }
  if (fabs(v) < 1e15 && v == (double)(long long)v) {
    char tmp[24];
    snprintf(tmp, sizeof tmp, "%lld", (long long)v);
    out += tmp;
    return true;
  }
  char* s = PyOS_double_to_string(v, 'r', 0, Py_DTSF_ADD_DOT_0, nullptr);
  if (!s) return false;
  out += s;
  PyMem_Free(s);
  return true;
}

bool append_ll(std::string& out, long long v) {
  char tmp[24];
  snprintf(tmp, sizeof tmp, "%lld", v);
  out += tmp;
  return true;
}

// labels + a trailing le="..." pair — the histogram bucket labelset.
bool append_labels_le(std::string& out, PyObject* labels, const char* le,
                      size_t le_len) {
  if (!PyTuple_Check(labels)) {
    err("labels is not a tuple");
    return false;
  }
  out += '{';
  const Py_ssize_t n = PyTuple_GET_SIZE(labels);
  for (Py_ssize_t i = 0; i < n; ++i) {
    if (i) out += ',';
    if (!append_label_pair(out, PyTuple_GET_ITEM(labels, i))) return false;
  }
  if (n) out += ',';
  out += "le=\"";
  out.append(le, le_len);  // numeric / "+Inf": never needs escaping
  out += "\"}";
  return true;
}

long long as_ll(PyObject* obj, bool* ok) {
  int overflow = 0;
  long long v = PyLong_AsLongLongAndOverflow(obj, &overflow);
  if (overflow || (v == -1 && PyErr_Occurred())) {
    if (!PyErr_Occurred()) err("histogram count out of native range");
    *ok = false;
    return 0;
  }
  *ok = true;
  return v;
}

// render_exposition(series, histograms, openmetrics) -> bytes.
// Byte-identical to Snapshot.render(openmetrics).encode(): families in
// configured (schema) order, histograms grouped by family in insertion
// order, "# EOF" in OpenMetrics mode, "" when nothing rendered.
PyObject* py_render_exposition(PyObject*, PyObject* args) {
  PyObject *series, *hists;
  int om;
  if (!PyArg_ParseTuple(args, "O!O!p", &PyTuple_Type, &series, &PyTuple_Type,
                        &hists, &om))
    return nullptr;
  if (!g_render_families)
    return err("configure_render() has not been called");
  const Py_ssize_t ns = PyTuple_GET_SIZE(series);
  PyObject* by_family = PyDict_New();
  if (!by_family) return nullptr;
  for (Py_ssize_t i = 0; i < ns; ++i) {
    PyObject* s = PyTuple_GET_ITEM(series, i);
    if (!PyTuple_Check(s) || PyTuple_GET_SIZE(s) != 3) {
      Py_DECREF(by_family);
      return err("series entry is not a (spec, labels, value) triple");
    }
    PyObject* name = PyObject_GetAttr(PyTuple_GET_ITEM(s, 0), g_a_name);
    if (!name) {
      Py_DECREF(by_family);
      return nullptr;
    }
    PyObject* group = PyDict_GetItemWithError(by_family, name);  // borrowed
    if (!group) {
      if (PyErr_Occurred()) {
        Py_DECREF(name);
        Py_DECREF(by_family);
        return nullptr;
      }
      group = PyList_New(0);
      if (!group || PyDict_SetItem(by_family, name, group) < 0) {
        Py_XDECREF(group);
        Py_DECREF(name);
        Py_DECREF(by_family);
        return nullptr;
      }
      Py_DECREF(group);  // dict holds it; borrowed ref stays valid
    }
    Py_DECREF(name);
    if (PyList_Append(group, s) < 0) {
      Py_DECREF(by_family);
      return nullptr;
    }
  }
  std::string out;
  out.reserve(256 + (size_t)ns * 64);
  bool fail = false;
  for (const auto& fam : *g_render_families) {
    PyObject* group = PyDict_GetItemWithError(by_family, fam.name);
    if (!group) {
      if (PyErr_Occurred()) {
        fail = true;
        break;
      }
      continue;
    }
    PyObject* hdr = om ? fam.om : fam.plain;
    out.append(PyBytes_AS_STRING(hdr), (size_t)PyBytes_GET_SIZE(hdr));
    const Py_ssize_t gn = PyList_GET_SIZE(group);
    for (Py_ssize_t i = 0; i < gn; ++i) {
      PyObject* s = PyList_GET_ITEM(group, i);
      out += fam.utf8;
      if (!append_labels(out, PyTuple_GET_ITEM(s, 1))) {
        fail = true;
        break;
      }
      out += ' ';
      PyObject* vo = PyTuple_GET_ITEM(s, 2);
      double v = PyFloat_Check(vo) ? PyFloat_AS_DOUBLE(vo)
                                   : PyFloat_AsDouble(vo);
      if ((v == -1.0 && PyErr_Occurred()) || !append_value(out, v)) {
        fail = true;
        break;
      }
      out += '\n';
    }
    if (fail) break;
  }
  Py_DECREF(by_family);
  if (fail) return nullptr;

  // Histograms: grouped by family in first-seen order (dict insertion
  // order), one HELP/TYPE header per family.
  const Py_ssize_t nh = PyTuple_GET_SIZE(hists);
  if (nh) {
    PyObject* hist_fams = PyDict_New();
    if (!hist_fams) return nullptr;
    for (Py_ssize_t i = 0; i < nh && !fail; ++i) {
      PyObject* hist = PyTuple_GET_ITEM(hists, i);
      PyObject* spec = PyObject_GetAttr(hist, g_a_spec);
      PyObject* name = spec ? PyObject_GetAttr(spec, g_a_name) : nullptr;
      Py_XDECREF(spec);
      if (!name) {
        fail = true;
        break;
      }
      PyObject* group = PyDict_GetItemWithError(hist_fams, name);
      if (!group) {
        if (PyErr_Occurred()) {
          Py_DECREF(name);
          fail = true;
          break;
        }
        group = PyList_New(0);
        if (!group || PyDict_SetItem(hist_fams, name, group) < 0) {
          Py_XDECREF(group);
          Py_DECREF(name);
          fail = true;
          break;
        }
        Py_DECREF(group);
      }
      Py_DECREF(name);
      if (PyList_Append(group, hist) < 0) {
        fail = true;
        break;
      }
    }
    PyObject *key, *group;
    Py_ssize_t dpos = 0;
    while (!fail && PyDict_Next(hist_fams, &dpos, &key, &group)) {
      PyObject* first = PyList_GET_ITEM(group, 0);
      PyObject* spec = PyObject_GetAttr(first, g_a_spec);
      PyObject* help = spec ? PyObject_GetAttr(spec, g_a_help) : nullptr;
      if (!help) {
        Py_XDECREF(spec);
        fail = true;
        break;
      }
      Py_ssize_t name_len = 0, help_len = 0;
      const char* name_utf8 = PyUnicode_AsUTF8AndSize(key, &name_len);
      const char* help_utf8 = PyUnicode_AsUTF8AndSize(help, &help_len);
      if (!name_utf8 || !help_utf8) {
        Py_DECREF(help);
        Py_DECREF(spec);
        fail = true;
        break;
      }
      std::string name(name_utf8, (size_t)name_len);
      out += "# HELP ";
      out += name;
      out += ' ';
      out.append(help_utf8, (size_t)help_len);
      out += "\n# TYPE ";
      out += name;
      out += " histogram\n";
      Py_DECREF(help);
      Py_DECREF(spec);
      const std::string bucket_name = name + "_bucket";
      const Py_ssize_t gn = PyList_GET_SIZE(group);
      for (Py_ssize_t i = 0; i < gn && !fail; ++i) {
        PyObject* hist = PyList_GET_ITEM(group, i);
        PyObject* buckets = PyObject_GetAttr(hist, g_a_buckets);
        PyObject* counts = buckets ? PyObject_GetAttr(hist, g_a_counts)
                                   : nullptr;
        PyObject* labels = counts ? PyObject_GetAttr(hist, g_a_labels)
                                  : nullptr;
        PyObject* total_o = labels ? PyObject_GetAttr(hist, g_a_total)
                                   : nullptr;
        PyObject* sum_o = total_o ? PyObject_GetAttr(hist, g_a_sum)
                                  : nullptr;
        if (!sum_o || !PyTuple_Check(buckets) || !PyTuple_Check(counts) ||
            !PyTuple_Check(labels) ||
            PyTuple_GET_SIZE(counts) < PyTuple_GET_SIZE(buckets)) {
          if (sum_o && !PyErr_Occurred())
            err("histogram state shape mismatch");
          fail = true;
        }
        bool ok = true;
        long long total = 0;
        double sum = 0.0;
        if (!fail) {
          total = as_ll(total_o, &ok);
          if (ok) {
            sum = PyFloat_AsDouble(sum_o);
            if (sum == -1.0 && PyErr_Occurred()) ok = false;
          }
          if (!ok) fail = true;
        }
        if (!fail) {
          long long cumulative = 0;
          const Py_ssize_t nb = PyTuple_GET_SIZE(buckets);
          for (Py_ssize_t b = 0; b < nb; ++b) {
            long long cnt = as_ll(PyTuple_GET_ITEM(counts, b), &ok);
            if (!ok) {
              fail = true;
              break;
            }
            cumulative += cnt;
            double bound = PyFloat_AsDouble(PyTuple_GET_ITEM(buckets, b));
            if (bound == -1.0 && PyErr_Occurred()) {
              fail = true;
              break;
            }
            std::string le;
            if (!append_value(le, bound)) {
              fail = true;
              break;
            }
            out += bucket_name;
            if (!append_labels_le(out, labels, le.data(), le.size())) {
              fail = true;
              break;
            }
            out += ' ';
            append_ll(out, cumulative);
            out += '\n';
          }
        }
        if (!fail) {
          out += bucket_name;
          if (!append_labels_le(out, labels, "+Inf", 4)) {
            fail = true;
          } else {
            out += ' ';
            append_ll(out, total);
            out += '\n';
            out += name;
            out += "_sum";
            if (!append_labels(out, labels)) {
              fail = true;
            } else {
              out += ' ';
              if (!append_value(out, sum)) {
                fail = true;
              } else {
                out += '\n';
                out += name;
                out += "_count";
                if (!append_labels(out, labels)) {
                  fail = true;
                } else {
                  out += ' ';
                  append_ll(out, total);
                  out += '\n';
                }
              }
            }
          }
        }
        Py_XDECREF(buckets);
        Py_XDECREF(counts);
        Py_XDECREF(labels);
        Py_XDECREF(total_o);
        Py_XDECREF(sum_o);
      }
    }
    Py_DECREF(hist_fams);
  }
  if (fail) return nullptr;
  if (om) out += "# EOF\n";
  if (out.empty()) return PyBytes_FromStringAndSize("", 0);
  return PyBytes_FromStringAndSize(out.data(), (Py_ssize_t)out.size());
}

// configure_gzip() state: the 10 header bytes the running interpreter's
// gzip.compress(b"", compresslevel=level, mtime=0) writes, per level 0-9.
// Python's gzip module has changed the header across versions (3.12 lets
// zlib write it: OS byte 3; older versions wrote OS byte 0xff), so the
// header is taken from whichever Python loads this module.
uint8_t g_gzip_headers[10][10];
bool g_gzip_configured = false;

PyObject* py_configure_gzip(PyObject*, PyObject* args) {
  PyObject* headers;
  if (!PyArg_ParseTuple(args, "O!", &PyTuple_Type, &headers)) return nullptr;
  if (PyTuple_GET_SIZE(headers) != 10)
    return err("configure_gzip expects one 10-byte header per level 0-9");
  uint8_t parsed[10][10];
  for (Py_ssize_t level = 0; level < 10; ++level) {
    PyObject* h = PyTuple_GET_ITEM(headers, level);
    if (!PyBytes_Check(h) || PyBytes_GET_SIZE(h) != 10)
      return err("configure_gzip expects one 10-byte header per level 0-9");
    memcpy(parsed[level], PyBytes_AS_STRING(h), 10);
  }
  memcpy(g_gzip_headers, parsed, sizeof parsed);
  g_gzip_configured = true;
  Py_RETURN_NONE;
}

// gzip_compress(data, level) -> bytes. Byte-identical to
// gzip.compress(data, compresslevel=level, mtime=0) on the interpreter
// that called configure_gzip: its header, a raw deflate stream
// (windowBits -15, memLevel 8, default strategy; the same libz the
// interpreter links), then crc32 + isize little-endian.
PyObject* py_gzip_compress(PyObject*, PyObject* args) {
  Py_buffer buf;
  int level;
  if (!PyArg_ParseTuple(args, "y*i", &buf, &level)) return nullptr;
  if (!g_gzip_configured) {
    PyBuffer_Release(&buf);
    return err("configure_gzip() has not been called");
  }
  if (level < 0 || level > 9 || buf.len > (Py_ssize_t)1 << 30) {
    PyBuffer_Release(&buf);
    return err("gzip_compress: unsupported level or oversized input");
  }
  z_stream strm;
  memset(&strm, 0, sizeof strm);
  if (deflateInit2(&strm, level, Z_DEFLATED, -15, 8, Z_DEFAULT_STRATEGY) !=
      Z_OK) {
    PyBuffer_Release(&buf);
    return err("deflateInit2 failed");
  }
  const uLong bound = deflateBound(&strm, (uLong)buf.len);
  PyObject* out_obj = PyBytes_FromStringAndSize(nullptr, 10 + bound + 8);
  if (!out_obj) {
    deflateEnd(&strm);
    PyBuffer_Release(&buf);
    return nullptr;
  }
  uint8_t* out = (uint8_t*)PyBytes_AS_STRING(out_obj);
  memcpy(out, g_gzip_headers[level], 10);
  strm.next_in = (Bytef*)buf.buf;
  strm.avail_in = (uInt)buf.len;
  strm.next_out = out + 10;
  strm.avail_out = (uInt)bound;
  const int rc = deflate(&strm, Z_FINISH);
  const size_t clen = strm.total_out;
  deflateEnd(&strm);
  if (rc != Z_STREAM_END) {
    Py_DECREF(out_obj);
    PyBuffer_Release(&buf);
    return err("deflate did not finish in one pass");
  }
  uint8_t* trailer = out + 10 + clen;
  const uint32_t crc =
      (uint32_t)crc32(crc32(0L, Z_NULL, 0), (const Bytef*)buf.buf,
                      (uInt)buf.len);
  const uint32_t isize = (uint32_t)((uint64_t)buf.len & 0xffffffffu);
  trailer[0] = crc & 0xff;
  trailer[1] = (crc >> 8) & 0xff;
  trailer[2] = (crc >> 16) & 0xff;
  trailer[3] = (crc >> 24) & 0xff;
  trailer[4] = isize & 0xff;
  trailer[5] = (isize >> 8) & 0xff;
  trailer[6] = (isize >> 16) & 0xff;
  trailer[7] = (isize >> 24) & 0xff;
  PyBuffer_Release(&buf);
  if (_PyBytes_Resize(&out_obj, (Py_ssize_t)(10 + clen + 8)) < 0)
    return nullptr;
  return out_obj;
}

// fold_rows(dst, src, at) — the hub refresh's frame-fold inner loop:
// for every (key, row) in src, dst[key] = row.clone_at(at). Clones the
// way ChipRow.clone_at does (fresh object, __dict__ copy, restamped at)
// so Frame.rates can mutate frame rows without touching the cached fold.
PyObject* py_fold_rows(PyObject*, PyObject* args) {
  PyObject *dst, *src, *at_obj;
  if (!PyArg_ParseTuple(args, "O!O!O", &PyDict_Type, &dst, &PyDict_Type,
                        &src, &at_obj))
    return nullptr;
  PyObject *key, *row;
  Py_ssize_t pos = 0;
  while (PyDict_Next(src, &pos, &key, &row)) {
    PyTypeObject* tp = Py_TYPE(row);
    PyObject* clone = tp->tp_new(tp, g_empty_tuple, nullptr);
    if (!clone) return nullptr;
    PyObject** dictptr = _PyObject_GetDictPtr(clone);
    PyObject* srcdict = PyObject_GetAttr(row, g_a_dict);
    if (!dictptr || !srcdict) {
      if (!PyErr_Occurred()) err("row has no instance __dict__");
      Py_XDECREF(srcdict);
      Py_DECREF(clone);
      return nullptr;
    }
    PyObject* newdict = PyDict_Copy(srcdict);
    Py_DECREF(srcdict);
    if (!newdict) {
      Py_DECREF(clone);
      return nullptr;
    }
    Py_XSETREF(*dictptr, newdict);
    if (PyDict_SetItem(newdict, g_a_at, at_obj) < 0 ||
        PyDict_SetItem(dst, key, clone) < 0) {
      Py_DECREF(clone);
      return nullptr;
    }
    Py_DECREF(clone);
  }
  Py_RETURN_NONE;
}

PyMethodDef methods[] = {
    {"configure_apply", py_configure_apply, METH_VARARGS,
     "configure_apply(series_cls) — pin the registry.Series class the "
     "batch apply constructs merge-plan pairs with."},
    {"apply_slots", py_apply_slots, METH_VARARGS,
     "apply_slots(entry, slots: tuple[int], values: tuple[float]) -> "
     "int — run the hub's per-slot delta patch loop natively over the "
     "entry's compiled patch program + value slab; returns invalidation "
     "flags (1 histogram fold, 2 fleet digest, 4 frame fold)."},
    {"decode_delta_slots", py_decode_delta_slots, METH_VARARGS,
     "decode_delta_slots(data, pos, count) -> (slots, values, end) | "
     "None — the DELTA frame slot/value walk of delta.decode_frame_raw; "
     "None means fall back to the exact-arithmetic Python loop."},
    {"decode_delta_frame", py_decode_delta_frame, METH_VARARGS,
     "decode_delta_frame(data) -> (source, generation, seq, slots, "
     "values, proto, caps, build) | None — the complete common-case "
     "DELTA decode of delta.decode_frame_raw in one call; None means "
     "fall back to the Python oracle (which owns every error verdict)."},
    {"configure_render", py_configure_render, METH_VARARGS,
     "configure_render(((name, plain_header, om_header), ...)) — pin the "
     "non-histogram family surface in schema render order."},
    {"render_exposition", py_render_exposition, METH_VARARGS,
     "render_exposition(series, histograms, openmetrics) -> bytes — "
     "byte-identical to Snapshot.render(openmetrics).encode()."},
    {"configure_gzip", py_configure_gzip, METH_VARARGS,
     "configure_gzip((header0, ..., header9)) — pin the 10-byte header "
     "gzip.compress(b'', compresslevel=level, mtime=0) writes per level."},
    {"gzip_compress", py_gzip_compress, METH_VARARGS,
     "gzip_compress(data, level) -> bytes — byte-identical to "
     "gzip.compress(data, compresslevel=level, mtime=0)."},
    {"fold_rows", py_fold_rows, METH_VARARGS,
     "fold_rows(dst, src, at) — dst[key] = row.clone_at(at) for every "
     "cached fold row; the hub frame-assembly inner loop."},
    {"snappy_uncompress", py_snappy_uncompress, METH_VARARGS,
     "snappy_uncompress(data: bytes) -> bytes — strict snappy "
     "block-format decode, semantics identical to "
     "snappy._decompress_py."},
    {nullptr, nullptr, 0, nullptr}};

PyModuleDef moduledef = {PyModuleDef_HEAD_INIT, "_wirefast",
                         "the hub's and exporter's host fast paths",
                         -1,  // no per-module state; globals above
                         methods, nullptr, nullptr, nullptr, nullptr};

}  // namespace

PyMODINIT_FUNC PyInit__wirefast(void) {
  PyObject* m = PyModule_Create(&moduledef);
  if (!m) return nullptr;
  g_s_ici_bps = PyUnicode_InternFromString("ici_bps");
  g_a_series = PyUnicode_InternFromString("series");
  g_a_series_dicts = PyUnicode_InternFromString("series_dicts");
  g_a_chip_plan = PyUnicode_InternFromString("chip_plan");
  g_a_rollup_plan = PyUnicode_InternFromString("rollup_plan");
  g_a_frame_rows = PyUnicode_InternFromString("frame_rows");
  g_a_frame_rollups = PyUnicode_InternFromString("frame_rollups");
  g_a_patch_program = PyUnicode_InternFromString("patch_program");
  g_a_value_slab = PyUnicode_InternFromString("value_slab");
  g_a_name = PyUnicode_InternFromString("name");
  g_a_help = PyUnicode_InternFromString("help");
  g_a_spec = PyUnicode_InternFromString("spec");
  g_a_buckets = PyUnicode_InternFromString("buckets");
  g_a_counts = PyUnicode_InternFromString("counts");
  g_a_total = PyUnicode_InternFromString("total");
  g_a_sum = PyUnicode_InternFromString("sum");
  g_a_labels = PyUnicode_InternFromString("labels");
  g_a_at = PyUnicode_InternFromString("at");
  g_a_dict = PyUnicode_InternFromString("__dict__");
  g_empty_tuple = PyTuple_New(0);
  if (!g_s_ici_bps || !g_a_series || !g_a_series_dicts || !g_a_chip_plan ||
      !g_a_rollup_plan || !g_a_frame_rows || !g_a_frame_rollups ||
      !g_a_patch_program || !g_a_value_slab || !g_a_name || !g_a_help ||
      !g_a_spec || !g_a_buckets || !g_a_counts || !g_a_total || !g_a_sum ||
      !g_a_labels || !g_a_at || !g_a_dict || !g_empty_tuple) {
    Py_DECREF(m);
    return nullptr;
  }
  return m;
}
