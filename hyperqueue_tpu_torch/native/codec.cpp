// msgpack's wire format as a CPython extension: the native backend of
// transport/codec.py.
//
// packb and unpackb here keep the semantics of the Python codec in
// transport/codec.py byte for byte (its docstring is the specification):
// the shortest int formats, OverflowError outside [-2**63, 2**64); bool
// before int; subclasses of int, float, str, bytes, dict, list and tuple
// pack as their base type (a subclass of dict through its items(), a
// subclass of list or tuple through len() and iteration, as the Python
// codec does); floats always as float 64; dicts in insertion order;
// bytearray and memoryview as bin; TypeError for anything else. Decoding
// raises the Python codec's CodecError (handed in by `configure`) for
// 0xc1, ext types, truncated input and trailing bytes, UnicodeDecodeError
// for invalid UTF-8 and ValueError for a non-str, non-bytes map key under
// strict_map_key. Nesting runs under Py_EnterRecursiveCall, so a deep
// value raises RecursionError where the Python codec does.
//
// Built at first use by transport/codec.py with the host's C++ compiler.

#define PY_SSIZE_T_CLEAN
#include <Python.h>

#include <cstdint>
#include <cstdlib>
#include <cstring>

namespace {

PyObject *g_codec_error = nullptr;  // transport.codec.CodecError

// ---------------------------------------------------------------------------
// encoding
// ---------------------------------------------------------------------------

struct Buffer {
    char *data = nullptr;
    size_t len = 0;
    size_t cap = 0;

    ~Buffer() { std::free(data); }

    bool reserve(size_t extra) {
        if (len + extra <= cap) return true;
        size_t want = cap ? cap * 2 : 256;
        while (want < len + extra) want *= 2;
        char *p = static_cast<char *>(std::realloc(data, want));
        if (p == nullptr) {
            PyErr_NoMemory();
            return false;
        }
        data = p;
        cap = want;
        return true;
    }

    bool put(const void *src, size_t n) {
        if (!reserve(n)) return false;
        std::memcpy(data + len, src, n);
        len += n;
        return true;
    }

    bool byte(uint8_t b) {
        if (!reserve(1)) return false;
        data[len++] = static_cast<char>(b);
        return true;
    }

    // type byte + big-endian payload of `width` bytes
    bool typed(uint8_t type, uint64_t v, int width) {
        if (!reserve(1 + width)) return false;
        data[len++] = static_cast<char>(type);
        for (int i = width - 1; i >= 0; --i)
            data[len++] = static_cast<char>((v >> (8 * i)) & 0xFF);
        return true;
    }
};

bool pack_int_value(Buffer &out, PyObject *obj) {
    int overflow = 0;
    long long v = PyLong_AsLongLongAndOverflow(obj, &overflow);
    if (v == -1 && PyErr_Occurred()) return false;
    if (overflow < 0) {
        PyErr_SetString(PyExc_OverflowError, "Integer value out of range");
        return false;
    }
    if (overflow > 0) {
        unsigned long long u = PyLong_AsUnsignedLongLong(obj);
        if (u == static_cast<unsigned long long>(-1) && PyErr_Occurred()) {
            PyErr_Clear();
            PyErr_SetString(PyExc_OverflowError,
                            "Integer value out of range");
            return false;
        }
        return out.typed(0xCF, u, 8);
    }
    if (v >= 0) {
        uint64_t u = static_cast<uint64_t>(v);
        if (u < 0x80) return out.byte(static_cast<uint8_t>(u));
        if (u <= 0xFF) return out.typed(0xCC, u, 1);
        if (u <= 0xFFFF) return out.typed(0xCD, u, 2);
        if (u <= 0xFFFFFFFFull) return out.typed(0xCE, u, 4);
        return out.typed(0xCF, u, 8);
    }
    if (v >= -32) return out.byte(static_cast<uint8_t>(v & 0xFF));
    uint64_t bits = static_cast<uint64_t>(v);
    if (v >= -0x80) return out.typed(0xD0, bits & 0xFF, 1);
    if (v >= -0x8000) return out.typed(0xD1, bits & 0xFFFF, 2);
    if (v >= -0x80000000LL) return out.typed(0xD2, bits & 0xFFFFFFFFull, 4);
    return out.typed(0xD3, bits, 8);
}

bool pack_double(Buffer &out, double d) {
    uint64_t bits;
    std::memcpy(&bits, &d, 8);
    return out.typed(0xCB, bits, 8);
}

bool pack_str_data(Buffer &out, const char *s, Py_ssize_t n) {
    size_t u = static_cast<size_t>(n);
    bool ok;
    if (u < 32)
        ok = out.byte(static_cast<uint8_t>(0xA0 | u));
    else if (u <= 0xFF)
        ok = out.typed(0xD9, u, 1);
    else if (u <= 0xFFFF)
        ok = out.typed(0xDA, u, 2);
    else if (u <= 0xFFFFFFFFull)
        ok = out.typed(0xDB, u, 4);
    else {
        PyErr_SetString(PyExc_ValueError, "str is too large");
        return false;
    }
    return ok && out.put(s, u);
}

bool pack_str(Buffer &out, PyObject *obj) {
    Py_ssize_t n;
    const char *s = PyUnicode_AsUTF8AndSize(obj, &n);
    if (s == nullptr) return false;
    return pack_str_data(out, s, n);
}

bool pack_bin_data(Buffer &out, const char *s, Py_ssize_t n) {
    size_t u = static_cast<size_t>(n);
    bool ok;
    if (u <= 0xFF)
        ok = out.typed(0xC4, u, 1);
    else if (u <= 0xFFFF)
        ok = out.typed(0xC5, u, 2);
    else if (u <= 0xFFFFFFFFull)
        ok = out.typed(0xC6, u, 4);
    else {
        PyErr_SetString(PyExc_ValueError, "bytes object is too large");
        return false;
    }
    return ok && out.put(s, u);
}

bool pack_array_header(Buffer &out, Py_ssize_t n) {
    size_t u = static_cast<size_t>(n);
    if (u < 16) return out.byte(static_cast<uint8_t>(0x90 | u));
    if (u <= 0xFFFF) return out.typed(0xDC, u, 2);
    if (u <= 0xFFFFFFFFull) return out.typed(0xDD, u, 4);
    PyErr_SetString(PyExc_ValueError, "list is too large");
    return false;
}

bool pack_map_header(Buffer &out, Py_ssize_t n) {
    size_t u = static_cast<size_t>(n);
    if (u < 16) return out.byte(static_cast<uint8_t>(0x80 | u));
    if (u <= 0xFFFF) return out.typed(0xDE, u, 2);
    if (u <= 0xFFFFFFFFull) return out.typed(0xDF, u, 4);
    PyErr_SetString(PyExc_ValueError, "dict is too large");
    return false;
}

bool pack(Buffer &out, PyObject *obj);

// a dict subclass, a list or tuple subclass: through the Python protocol
bool pack_items(Buffer &out, PyObject *obj) {
    Py_ssize_t n = PyObject_Size(obj);
    if (n < 0 || !pack_map_header(out, n)) return false;
    PyObject *items = PyObject_CallMethod(obj, "items", nullptr);
    if (items == nullptr) return false;
    PyObject *it = PyObject_GetIter(items);
    Py_DECREF(items);
    if (it == nullptr) return false;
    PyObject *pair;
    bool ok = true;
    while (ok && (pair = PyIter_Next(it)) != nullptr) {
        PyObject *k, *v;
        if (PyTuple_Check(pair) && PyTuple_GET_SIZE(pair) == 2) {
            k = PyTuple_GET_ITEM(pair, 0);
            v = PyTuple_GET_ITEM(pair, 1);
            ok = pack(out, k) && pack(out, v);
        } else {
            PyObject *seq = PySequence_Tuple(pair);
            if (seq == nullptr || PyTuple_GET_SIZE(seq) != 2) {
                if (seq != nullptr)
                    PyErr_SetString(PyExc_ValueError,
                                    "items() yielded a non-pair");
                ok = false;
            } else {
                ok = pack(out, PyTuple_GET_ITEM(seq, 0)) &&
                     pack(out, PyTuple_GET_ITEM(seq, 1));
            }
            Py_XDECREF(seq);
        }
        Py_DECREF(pair);
    }
    Py_DECREF(it);
    return ok && !PyErr_Occurred();
}

bool pack_iterable(Buffer &out, PyObject *obj) {
    Py_ssize_t n = PyObject_Size(obj);
    if (n < 0 || !pack_array_header(out, n)) return false;
    PyObject *it = PyObject_GetIter(obj);
    if (it == nullptr) return false;
    PyObject *v;
    bool ok = true;
    while (ok && (v = PyIter_Next(it)) != nullptr) {
        ok = pack(out, v);
        Py_DECREF(v);
    }
    Py_DECREF(it);
    return ok && !PyErr_Occurred();
}

bool pack_other(Buffer &out, PyObject *obj) {
    if (PyBool_Check(obj)) return out.byte(obj == Py_True ? 0xC3 : 0xC2);
    if (PyLong_Check(obj)) return pack_int_value(out, obj);
    if (PyFloat_Check(obj)) return pack_double(out, PyFloat_AS_DOUBLE(obj));
    if (PyBytes_Check(obj))
        return pack_bin_data(out, PyBytes_AS_STRING(obj),
                             PyBytes_GET_SIZE(obj));
    if (PyByteArray_Check(obj))
        return pack_bin_data(out, PyByteArray_AS_STRING(obj),
                             PyByteArray_GET_SIZE(obj));
    if (PyUnicode_Check(obj)) return pack_str(out, obj);
    if (PyDict_Check(obj)) return pack_items(out, obj);
    if (PyList_Check(obj) || PyTuple_Check(obj))
        return pack_iterable(out, obj);
    if (PyMemoryView_Check(obj)) {
        PyObject *data = PyObject_CallMethod(obj, "tobytes", nullptr);
        if (data == nullptr) return false;
        bool ok = pack_bin_data(out, PyBytes_AS_STRING(data),
                                PyBytes_GET_SIZE(data));
        Py_DECREF(data);
        return ok;
    }
    PyObject *name = PyType_GetName(Py_TYPE(obj));
    if (name != nullptr) {
        PyErr_Format(PyExc_TypeError, "can not serialize %R object", name);
        Py_DECREF(name);
    }
    return false;
}

bool pack(Buffer &out, PyObject *obj) {
    PyTypeObject *t = Py_TYPE(obj);
    if (t == &PyUnicode_Type) return pack_str(out, obj);
    if (t == &PyLong_Type) return pack_int_value(out, obj);
    if (obj == Py_None) return out.byte(0xC0);
    if (obj == Py_True) return out.byte(0xC3);
    if (obj == Py_False) return out.byte(0xC2);
    if (t == &PyFloat_Type) return pack_double(out, PyFloat_AS_DOUBLE(obj));
    if (t == &PyBytes_Type)
        return pack_bin_data(out, PyBytes_AS_STRING(obj),
                             PyBytes_GET_SIZE(obj));
    if (t == &PyDict_Type || t == &PyList_Type || t == &PyTuple_Type) {
        if (Py_EnterRecursiveCall(" while encoding msgpack")) return false;
        bool ok = true;
        if (t == &PyDict_Type) {
            ok = pack_map_header(out, PyDict_GET_SIZE(obj));
            Py_ssize_t pos = 0;
            PyObject *k, *v;
            while (ok && PyDict_Next(obj, &pos, &k, &v)) {
                Py_INCREF(k);
                Py_INCREF(v);
                ok = pack(out, k) && pack(out, v);
                Py_DECREF(k);
                Py_DECREF(v);
            }
        } else {
            PyObject *seq = obj;
            Py_ssize_t n = t == &PyList_Type ? PyList_GET_SIZE(seq)
                                             : PyTuple_GET_SIZE(seq);
            ok = pack_array_header(out, n);
            for (Py_ssize_t i = 0; ok && i < n; ++i) {
                // a list may shrink under a __del__ run by a nested pack
                if (t == &PyList_Type && i >= PyList_GET_SIZE(seq)) break;
                PyObject *v = t == &PyList_Type ? PyList_GET_ITEM(seq, i)
                                                : PyTuple_GET_ITEM(seq, i);
                Py_INCREF(v);
                ok = pack(out, v);
                Py_DECREF(v);
            }
        }
        Py_LeaveRecursiveCall();
        return ok;
    }
    if (Py_EnterRecursiveCall(" while encoding msgpack")) return false;
    bool ok = pack_other(out, obj);
    Py_LeaveRecursiveCall();
    return ok;
}

PyObject *py_packb(PyObject *, PyObject *obj) {
    Buffer out;
    if (!pack(out, obj)) return nullptr;
    return PyBytes_FromStringAndSize(out.data ? out.data : "",
                                     static_cast<Py_ssize_t>(out.len));
}

// ---------------------------------------------------------------------------
// decoding
// ---------------------------------------------------------------------------

struct Reader {
    const uint8_t *data;
    size_t pos;
    size_t end;
    bool strict_map_key;
};

PyObject *incomplete() {
    PyErr_SetString(g_codec_error, "Unpack failed: incomplete input");
    return nullptr;
}

// big-endian unsigned of `width` bytes at r.pos; false when truncated
bool read_be(Reader &r, int width, uint64_t *out) {
    if (r.end - r.pos < static_cast<size_t>(width)) return false;
    uint64_t v = 0;
    for (int i = 0; i < width; ++i) v = (v << 8) | r.data[r.pos + i];
    r.pos += width;
    *out = v;
    return true;
}

PyObject *value(Reader &r);

PyObject *build_array(Reader &r, uint64_t n) {
    // every element takes at least one byte: a length beyond the input
    // grows the list as it decodes (and ends in "incomplete" where the
    // Python codec does, after decoding what is there)
    size_t left = r.end - r.pos;
    if (n <= left) {
        PyObject *list = PyList_New(static_cast<Py_ssize_t>(n));
        if (list == nullptr) return nullptr;
        for (uint64_t i = 0; i < n; ++i) {
            PyObject *v = value(r);
            if (v == nullptr) {
                Py_DECREF(list);
                return nullptr;
            }
            PyList_SET_ITEM(list, static_cast<Py_ssize_t>(i), v);
        }
        return list;
    }
    PyObject *list = PyList_New(0);
    if (list == nullptr) return nullptr;
    for (uint64_t i = 0; i < n; ++i) {
        PyObject *v = value(r);
        if (v == nullptr || PyList_Append(list, v) < 0) {
            Py_XDECREF(v);
            Py_DECREF(list);
            return nullptr;
        }
        Py_DECREF(v);
    }
    return list;
}

PyObject *build_map(Reader &r, uint64_t n) {
    PyObject *out = PyDict_New();
    if (out == nullptr) return nullptr;
    for (uint64_t i = 0; i < n; ++i) {
        PyObject *k = value(r);
        if (k == nullptr) {
            Py_DECREF(out);
            return nullptr;
        }
        PyObject *v = value(r);
        if (v == nullptr) {
            Py_DECREF(k);
            Py_DECREF(out);
            return nullptr;
        }
        if (r.strict_map_key && !PyUnicode_CheckExact(k) &&
            !PyBytes_CheckExact(k)) {
            PyErr_Format(PyExc_ValueError,
                         "%s is not allowed for map key when "
                         "strict_map_key=True",
                         Py_TYPE(k)->tp_name);
            Py_DECREF(k);
            Py_DECREF(v);
            Py_DECREF(out);
            return nullptr;
        }
        int rc = PyDict_SetItem(out, k, v);
        Py_DECREF(k);
        Py_DECREF(v);
        if (rc < 0) {
            Py_DECREF(out);
            return nullptr;
        }
    }
    return out;
}

PyObject *sized(Reader &r, uint8_t b, int width) {
    uint64_t n;
    if (!read_be(r, width, &n)) return incomplete();
    if (b >= 0xDC) {  // array 16/32, map 16/32
        if (Py_EnterRecursiveCall(" while decoding msgpack")) return nullptr;
        PyObject *v = b <= 0xDD ? build_array(r, n) : build_map(r, n);
        Py_LeaveRecursiveCall();
        return v;
    }
    if (r.end - r.pos < n) return incomplete();
    const char *s = reinterpret_cast<const char *>(r.data + r.pos);
    r.pos += n;
    if (b >= 0xD9)  // str 8/16/32
        return PyUnicode_DecodeUTF8(s, static_cast<Py_ssize_t>(n), "strict");
    return PyBytes_FromStringAndSize(s, static_cast<Py_ssize_t>(n));
}

PyObject *value(Reader &r) {
    if (r.pos >= r.end) return incomplete();
    uint8_t b = r.data[r.pos++];
    if (b < 0x80) return PyLong_FromLong(b);
    if (b < 0xA0) {
        if (Py_EnterRecursiveCall(" while decoding msgpack")) return nullptr;
        PyObject *v = b < 0x90 ? build_map(r, b & 0x0F)
                               : build_array(r, b & 0x0F);
        Py_LeaveRecursiveCall();
        return v;
    }
    if (b < 0xC0) {
        size_t n = b & 0x1F;
        if (r.end - r.pos < n) return incomplete();
        const char *s = reinterpret_cast<const char *>(r.data + r.pos);
        r.pos += n;
        return PyUnicode_DecodeUTF8(s, static_cast<Py_ssize_t>(n), "strict");
    }
    if (b >= 0xE0) return PyLong_FromLong(static_cast<long>(b) - 0x100);
    uint64_t v;
    switch (b) {
        case 0xC0:
            Py_RETURN_NONE;
        case 0xC2:
            Py_RETURN_FALSE;
        case 0xC3:
            Py_RETURN_TRUE;
        case 0xCA: {
            if (!read_be(r, 4, &v)) return incomplete();
            uint32_t bits = static_cast<uint32_t>(v);
            float f;
            std::memcpy(&f, &bits, 4);
            return PyFloat_FromDouble(static_cast<double>(f));
        }
        case 0xCB: {
            if (!read_be(r, 8, &v)) return incomplete();
            double d;
            std::memcpy(&d, &v, 8);
            return PyFloat_FromDouble(d);
        }
        case 0xCC:
            if (!read_be(r, 1, &v)) return incomplete();
            return PyLong_FromUnsignedLongLong(v);
        case 0xCD:
            if (!read_be(r, 2, &v)) return incomplete();
            return PyLong_FromUnsignedLongLong(v);
        case 0xCE:
            if (!read_be(r, 4, &v)) return incomplete();
            return PyLong_FromUnsignedLongLong(v);
        case 0xCF:
            if (!read_be(r, 8, &v)) return incomplete();
            return PyLong_FromUnsignedLongLong(v);
        case 0xD0:
            if (!read_be(r, 1, &v)) return incomplete();
            return PyLong_FromLong(static_cast<int8_t>(v));
        case 0xD1:
            if (!read_be(r, 2, &v)) return incomplete();
            return PyLong_FromLong(static_cast<int16_t>(v));
        case 0xD2:
            if (!read_be(r, 4, &v)) return incomplete();
            return PyLong_FromLong(static_cast<int32_t>(v));
        case 0xD3:
            if (!read_be(r, 8, &v)) return incomplete();
            return PyLong_FromLongLong(static_cast<int64_t>(v));
        case 0xD9:
        case 0xC4:
            return sized(r, b, 1);
        case 0xDA:
        case 0xC5:
        case 0xDC:
        case 0xDE:
            return sized(r, b, 2);
        case 0xDB:
        case 0xC6:
        case 0xDD:
        case 0xDF:
            return sized(r, b, 4);
        case 0xC1:
            PyErr_SetString(g_codec_error,
                            "Unpack failed: reserved type byte 0xc1");
            return nullptr;
        default:
            // 0xc7-0xc9 ext 8/16/32, 0xd4-0xd8 fixext
            PyErr_Format(g_codec_error,
                         "Unpack failed: ext type 0x%02x is not used",
                         static_cast<unsigned>(b));
            return nullptr;
    }
}

PyObject *py_unpackb(PyObject *, PyObject *args, PyObject *kwargs) {
    static const char *kwlist[] = {"data", "strict_map_key", nullptr};
    PyObject *data;
    int strict = 1;
    if (!PyArg_ParseTupleAndKeywords(args, kwargs, "O|$p",
                                     const_cast<char **>(kwlist), &data,
                                     &strict))
        return nullptr;
    if (g_codec_error == nullptr) {
        PyErr_SetString(PyExc_RuntimeError, "codec is not configured");
        return nullptr;
    }
    PyObject *owned = nullptr;
    if (!PyBytes_CheckExact(data)) {  // as the Python codec: bytes(data)
        owned = PyObject_CallOneArg(reinterpret_cast<PyObject *>(
                                        &PyBytes_Type), data);
        if (owned == nullptr) return nullptr;
        data = owned;
    }
    Reader r{reinterpret_cast<const uint8_t *>(PyBytes_AS_STRING(data)), 0,
             static_cast<size_t>(PyBytes_GET_SIZE(data)), strict != 0};
    PyObject *obj = value(r);
    if (obj != nullptr && r.pos != r.end) {
        Py_DECREF(obj);
        obj = nullptr;
        PyErr_SetString(g_codec_error, "unpack(b) received extra data.");
    }
    Py_XDECREF(owned);
    return obj;
}

PyObject *py_configure(PyObject *, PyObject *error_class) {
    if (!PyType_Check(error_class) ||
        !PyType_IsSubtype(reinterpret_cast<PyTypeObject *>(error_class),
                          reinterpret_cast<PyTypeObject *>(
                              PyExc_ValueError))) {
        PyErr_SetString(PyExc_TypeError,
                        "configure() takes a ValueError subclass");
        return nullptr;
    }
    Py_INCREF(error_class);
    Py_XSETREF(g_codec_error, error_class);
    Py_RETURN_NONE;
}

PyMethodDef methods[] = {
    {"packb", py_packb, METH_O,
     "obj in msgpack's wire format, as transport.codec's Python packb."},
    {"unpackb", reinterpret_cast<PyCFunction>(
                    reinterpret_cast<void (*)(void)>(py_unpackb)),
     METH_VARARGS | METH_KEYWORDS,
     "unpackb(data, *, strict_map_key=True): one msgpack value, as "
     "transport.codec's Python unpackb."},
    {"configure", py_configure, METH_O,
     "configure(CodecError): the class raised for malformed input."},
    {nullptr, nullptr, 0, nullptr},
};

PyModuleDef module = {
    PyModuleDef_HEAD_INIT, "_hqcodec",
    "msgpack's wire format in C++: the native backend of "
    "hyperqueue_tpu_torch.transport.codec.",
    -1, methods, nullptr, nullptr, nullptr, nullptr,
};

}  // namespace

PyMODINIT_FUNC PyInit__hqcodec(void) { return PyModule_Create(&module); }
