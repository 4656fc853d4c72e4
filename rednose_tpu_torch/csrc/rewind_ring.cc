// Native rewind/replay checkpoint ring of the port's streaming filter
// engine (runtime/driver.py).
//
// The port's copy of rednose_tpu/runtime/_rewind.cc, itself the
// counterpart of the reference's C++ engine-side rewind machinery
// (rednose/helpers/ekf_sym.cc:119-156: std::deque checkpoint ring, binary
// rewind search, replay-cache rotation, REWIND_TO_KEEP=512 ekf_sym.h:18).
// The numeric step runs in torch; the host work left per observation is
// this time bookkeeping, which runs at sensor rate, so it stays out of the
// Python loop. Built by the host C++ compiler at first use
// (rednose_tpu_torch/_build.py, rewind_ring_type) into build/rednose_tpu_torch/
// and loaded as the module rednose_tpu_torch.runtime._rewind_ring.
//
// Checkpointed states are opaque PyObjects held by reference: the port's
// engine replaces its (x, P) tensors and never writes into a checkpointed
// one, so a checkpoint is a reference, not a copy (unlike the reference's
// np.copy snapshots, ekf_sym.py:443).

#define PY_SSIZE_T_CLEAN
#include <Python.h>

#include <algorithm>
#include <vector>

namespace {

struct Entry {
  double t;
  PyObject* state;  // owned
  PyObject* obs;    // owned
};

struct RewindRing {
  PyObject_HEAD
  std::vector<Entry>* entries;
  Py_ssize_t capacity;
};

void clear_entries(RewindRing* self) {
  for (Entry& e : *self->entries) {
    Py_XDECREF(e.state);
    Py_XDECREF(e.obs);
  }
  self->entries->clear();
}

int RewindRing_init(RewindRing* self, PyObject* args, PyObject* kwds) {
  Py_ssize_t capacity = 512;
  static const char* kwlist[] = {"capacity", nullptr};
  if (!PyArg_ParseTupleAndKeywords(args, kwds, "|n",
                                   const_cast<char**>(kwlist), &capacity)) {
    return -1;
  }
  if (capacity <= 0) {
    PyErr_SetString(PyExc_ValueError, "capacity must be positive");
    return -1;
  }
  self->entries = new std::vector<Entry>();
  self->entries->reserve(static_cast<size_t>(capacity));
  self->capacity = capacity;
  return 0;
}

void RewindRing_dealloc(RewindRing* self) {
  if (self->entries != nullptr) {
    clear_entries(self);
    delete self->entries;
  }
  Py_TYPE(self)->tp_free(reinterpret_cast<PyObject*>(self));
}

PyObject* RewindRing_checkpoint(RewindRing* self, PyObject* args) {
  double t;
  PyObject* state;
  PyObject* obs;
  if (!PyArg_ParseTuple(args, "dOO", &t, &state, &obs)) return nullptr;
  if (!self->entries->empty() && t < self->entries->back().t) {
    PyErr_SetString(PyExc_ValueError,
                    "checkpoint time must be non-decreasing");
    return nullptr;
  }
  Py_INCREF(state);
  Py_INCREF(obs);
  self->entries->push_back(Entry{t, state, obs});
  if (static_cast<Py_ssize_t>(self->entries->size()) > self->capacity) {
    size_t excess = self->entries->size() - self->capacity;
    for (size_t i = 0; i < excess; ++i) {
      Py_XDECREF((*self->entries)[i].state);
      Py_XDECREF((*self->entries)[i].obs);
    }
    self->entries->erase(self->entries->begin(),
                         self->entries->begin() + excess);
  }
  Py_RETURN_NONE;
}

// rewind(t) -> (t_restore, state_restore, [obs to replay, oldest first])
// Rolls back to the newest checkpoint with time <= t; entries after it are
// dropped from the ring and their observations returned for replay
// (semantics of ekf_sym.py:418-438 / ekf_sym.cc:119-143).
PyObject* RewindRing_rewind(RewindRing* self, PyObject* args) {
  double t;
  if (!PyArg_ParseTuple(args, "d", &t)) return nullptr;
  auto& v = *self->entries;
  // idx = first entry with entry.t > t (upper bound)
  auto it = std::upper_bound(
      v.begin(), v.end(), t,
      [](double val, const Entry& e) { return val < e.t; });
  if (it == v.begin()) {
    PyErr_SetString(PyExc_ValueError, "rewind target older than ring");
    return nullptr;
  }
  size_t idx = static_cast<size_t>(it - v.begin());
  PyObject* replay = PyList_New(static_cast<Py_ssize_t>(v.size() - idx));
  if (replay == nullptr) return nullptr;
  for (size_t i = idx; i < v.size(); ++i) {
    Py_INCREF(v[i].obs);
    PyList_SET_ITEM(replay, static_cast<Py_ssize_t>(i - idx), v[i].obs);
    Py_XDECREF(v[i].state);
    Py_XDECREF(v[i].obs);
  }
  v.resize(idx);
  const Entry& restore = v.back();
  PyObject* out = Py_BuildValue("dON", restore.t, restore.state, replay);
  return out;
}

PyObject* RewindRing_can_rewind(RewindRing* self, PyObject* args) {
  double t, max_age;
  if (!PyArg_ParseTuple(args, "dd", &t, &max_age)) return nullptr;
  auto& v = *self->entries;
  bool ok = !v.empty() && t >= v.front().t && t >= v.back().t - max_age;
  return PyBool_FromLong(ok ? 1 : 0);
}

PyObject* RewindRing_clear(RewindRing* self, PyObject* /*ignored*/) {
  clear_entries(self);
  Py_RETURN_NONE;
}

PyObject* RewindRing_first_t(RewindRing* self, PyObject* /*ignored*/) {
  if (self->entries->empty()) Py_RETURN_NONE;
  return PyFloat_FromDouble(self->entries->front().t);
}

PyObject* RewindRing_last_t(RewindRing* self, PyObject* /*ignored*/) {
  if (self->entries->empty()) Py_RETURN_NONE;
  return PyFloat_FromDouble(self->entries->back().t);
}

Py_ssize_t RewindRing_len(PyObject* self) {
  return static_cast<Py_ssize_t>(
      reinterpret_cast<RewindRing*>(self)->entries->size());
}

PyMethodDef RewindRing_methods[] = {
    {"checkpoint", reinterpret_cast<PyCFunction>(RewindRing_checkpoint),
     METH_VARARGS, "checkpoint(t, state, obs)"},
    {"rewind", reinterpret_cast<PyCFunction>(RewindRing_rewind), METH_VARARGS,
     "rewind(t) -> (t_restore, state, replay_obs_list)"},
    {"can_rewind", reinterpret_cast<PyCFunction>(RewindRing_can_rewind),
     METH_VARARGS, "can_rewind(t, max_rewind_age) -> bool"},
    {"clear", reinterpret_cast<PyCFunction>(RewindRing_clear), METH_NOARGS,
     "drop all checkpoints"},
    {"first_t", reinterpret_cast<PyCFunction>(RewindRing_first_t), METH_NOARGS,
     "oldest checkpoint time or None"},
    {"last_t", reinterpret_cast<PyCFunction>(RewindRing_last_t), METH_NOARGS,
     "newest checkpoint time or None"},
    {nullptr, nullptr, 0, nullptr},
};

PySequenceMethods RewindRing_as_sequence = {
    RewindRing_len,  // sq_length
};

PyTypeObject RewindRingType = {
    PyVarObject_HEAD_INIT(nullptr, 0)
};

PyModuleDef rewind_module = {
    PyModuleDef_HEAD_INIT, "_rewind_ring",
    "Native rewind/replay checkpoint ring", -1,
    nullptr, nullptr, nullptr, nullptr, nullptr,
};

}  // namespace

PyMODINIT_FUNC PyInit__rewind_ring(void) {
  RewindRingType.tp_name = "rednose_tpu_torch.runtime._rewind_ring.RewindRing";
  RewindRingType.tp_basicsize = sizeof(RewindRing);
  RewindRingType.tp_dealloc =
      reinterpret_cast<destructor>(RewindRing_dealloc);
  RewindRingType.tp_flags = Py_TPFLAGS_DEFAULT;
  RewindRingType.tp_methods = RewindRing_methods;
  RewindRingType.tp_as_sequence = &RewindRing_as_sequence;
  RewindRingType.tp_init = reinterpret_cast<initproc>(RewindRing_init);
  RewindRingType.tp_new = PyType_GenericNew;
  if (PyType_Ready(&RewindRingType) < 0) return nullptr;

  PyObject* m = PyModule_Create(&rewind_module);
  if (m == nullptr) return nullptr;
  Py_INCREF(&RewindRingType);
  if (PyModule_AddObject(m, "RewindRing",
                         reinterpret_cast<PyObject*>(&RewindRingType)) < 0) {
    Py_DECREF(&RewindRingType);
    Py_DECREF(m);
    return nullptr;
  }
  return m;
}
