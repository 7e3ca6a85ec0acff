// C API of the JAX tfQMR framework (see include/tfqmrgpu_tpu.h).
//
// The reference implements its C API directly over CUDA
// (tfQMRgpu/source/tfqmrgpu.cu); here the compute path is JAX/XLA, so
// this translation unit embeds CPython and forwards every call to the
// marshalling bridge (tfqmrgpu_tpu/capi_bridge.py), which drives the parity
// layer (tfqmrgpu_tpu/api.py).  The embedded side stays minimal: one
// PyObject_CallMethod per API function, pointer arguments passed as int64
// addresses, one PyLong decode of the result (>= 0 value, < 0 negated packed
// status).
//
// Error-string decoding (tfqmrgpuGetErrorString) is pure C so it works even
// when Python failed to initialize; the packing mirrors the reference
// (code + 1000*line + 10^7*char, tfqmrgpu.h:179-181).

#include <Python.h>

#include <cstdarg>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <mutex>

#include "tfqmrgpu_tpu.h"

namespace {

std::once_flag g_init_once;
PyObject* g_bridge = nullptr;      // tfqmrgpu_tpu.capi_bridge module
bool g_we_initialized = false;

void initialize_python() {
    if (!Py_IsInitialized()) {
        Py_InitializeEx(0);
        g_we_initialized = true;
    }
    PyGILState_STATE gil = PyGILState_Ensure();
    g_bridge = PyImport_ImportModule("tfqmrgpu_tpu.capi_bridge");
    if (g_bridge == nullptr) {
        PyErr_Print();
        std::fprintf(stderr,
                     "tfqmrgpu_tpu: cannot import tfqmrgpu_tpu.capi_bridge; "
                     "is the package on PYTHONPATH?\n");
    }
    PyGILState_Release(gil);
    if (g_we_initialized) {
        // release the GIL acquired by Py_InitializeEx so later
        // PyGILState_Ensure calls (possibly from other threads) can take it
        PyEval_SaveThread();
    }
}

// Call a bridge function with a printf-style CPython format string; returns
// the int64 result (< 0: negated packed status) or UNDOCUMENTED_ERROR when
// the call itself failed.
int64_t call_bridge(const char* name, const char* fmt, ...) {
    std::call_once(g_init_once, initialize_python);
    if (g_bridge == nullptr) return TFQMRGPU_UNDOCUMENTED_ERROR;

    PyGILState_STATE gil = PyGILState_Ensure();
    va_list ap;
    va_start(ap, fmt);
    PyObject* args = Py_VaBuildValue(fmt, ap);
    va_end(ap);
    int64_t value = TFQMRGPU_UNDOCUMENTED_ERROR;
    if (args != nullptr) {
        PyObject* fn = PyObject_GetAttrString(g_bridge, name);
        if (fn != nullptr) {
            PyObject* res = PyObject_CallObject(fn, args);
            if (res != nullptr) {
                value = PyLong_AsLongLong(res);
                Py_DECREF(res);
            } else {
                PyErr_Print();
            }
            Py_DECREF(fn);
        } else {
            PyErr_Print();
        }
        Py_DECREF(args);
    } else {
        PyErr_Print();
    }
    PyGILState_Release(gil);
    return value;
}

inline tfqmrgpuStatus_t as_status(int64_t v) {
    return v < 0 ? static_cast<tfqmrgpuStatus_t>(-v) : TFQMRGPU_STATUS_SUCCESS;
}

inline int64_t addr(const void* p) {
    return static_cast<int64_t>(reinterpret_cast<uintptr_t>(p));
}

}  // namespace

extern "C" {

/* ------------------------------------------------------------- errors -- */

const char* tfqmrgpuGetErrorString(tfqmrgpuStatus_t status) {
    static thread_local char buf[160];
    const int code = status % TFQMRGPU_CODE_LINE;
    const int line = (status / TFQMRGPU_CODE_LINE) % 10000;
    const int chr = status / TFQMRGPU_CODE_CHAR;
    const char* msg = "unknown status code";
    switch (code) {
        case TFQMRGPU_STATUS_SUCCESS:           msg = "success"; break;
        case TFQMRGPU_STATUS_LAUNCH_FAILED:     msg = "kernel launch failed"; break;
        case TFQMRGPU_STATUS_NO_INFO_PASSED:    msg = "no info passed"; break;
        case TFQMRGPU_STATUS_ALLOCATION_FAILED: msg = "allocation failed"; break;
        case TFQMRGPU_STATUS_RANDOM_GEN_FAILED: msg = "random number generation failed"; break;
        case TFQMRGPU_STATUS_BREAKDOWN:         msg = "all right-hand sides broke down"; break;
        case TFQMRGPU_POINTER_INVALID:          msg = "pointer invalid"; break;
        case TFQMRGPU_STATUS_MAX_ITERATIONS:    msg = "max iterations reached without convergence"; break;
        case TFQMRGPU_B_HAS_A_ZERO_COLUMN:      msg = "B has a zero column"; break;
        case TFQMRGPU_BLOCKSIZE_MISSING:        msg = "block size not in the allowed list"; break;
        case TFQMRGPU_B_IS_NOT_SUBSET_OF_X:     msg = "sparsity pattern of B is not a subset of X"; break;
        case TFQMRGPU_UNDOCUMENTED_ERROR:       msg = "undocumented error"; break;
        case TFQMRGPU_DATALAYOUT_UNKNOWN:       msg = "unknown data layout"; break;
        case TFQMRGPU_PRECISION_MISSMATCH:      msg = "precision mismatch"; break;
        case TFQMRGPU_TANSPOSITION_UNKNOWN:     msg = "unknown transposition"; break;
        case TFQMRGPU_VARIABLENAME_UNKNOWN:     msg = "unknown variable name"; break;
        case TFQMRGPU_NO_IMPLEMENTATION:        msg = "not implemented"; break;
        default: break;
    }
    if (line > 0 && chr > 0) {
        std::snprintf(buf, sizeof(buf), "%s (line %d, payload '%c')", msg, line, chr);
    } else if (line > 0) {
        std::snprintf(buf, sizeof(buf), "%s (line %d)", msg, line);
    } else if (chr > 0) {
        std::snprintf(buf, sizeof(buf), "%s (payload '%c')", msg, chr);
    } else {
        std::snprintf(buf, sizeof(buf), "%s", msg);
    }
    return buf;
}

tfqmrgpuStatus_t tfqmrgpuPrintError(tfqmrgpuStatus_t status) {
    std::fprintf(stderr, "tfqmrgpu status %d: %s\n", status,
                 tfqmrgpuGetErrorString(status));
    return TFQMRGPU_STATUS_SUCCESS;
}

/* ------------------------------------------------------------- handle -- */

tfqmrgpuStatus_t tfqmrgpuCreateHandle(tfqmrgpuHandle_t* handle) {
    if (handle == nullptr || *handle != 0) return TFQMRGPU_POINTER_INVALID;
    const int64_t v = call_bridge("h_create", "()");
    if (v < 0) return as_status(v);
    *handle = v;
    return TFQMRGPU_STATUS_SUCCESS;
}

tfqmrgpuStatus_t tfqmrgpuDestroyHandle(tfqmrgpuHandle_t handle) {
    return as_status(call_bridge("h_destroy", "(L)", (long long)handle));
}

tfqmrgpuStatus_t tfqmrgpuSetStream(tfqmrgpuHandle_t handle, int64_t streamId) {
    return as_status(call_bridge("h_set_stream", "(LL)", (long long)handle,
                                 (long long)streamId));
}

tfqmrgpuStatus_t tfqmrgpuGetStream(tfqmrgpuHandle_t handle, int64_t* streamId) {
    return as_status(call_bridge("h_get_stream", "(LL)", (long long)handle,
                                 (long long)addr(streamId)));
}

/* ---------------------------------------------------------- workspace -- */

tfqmrgpuStatus_t tfqmrgpuCreateWorkspace(void** pBuffer, size_t sizeInBytes,
                                         char memType) {
    (void)memType;  // XLA owns device memory; the token is opaque
    if (pBuffer == nullptr) return TFQMRGPU_POINTER_INVALID;
    *pBuffer = reinterpret_cast<void*>(static_cast<uintptr_t>(
        sizeInBytes ? sizeInBytes : 1));
    return TFQMRGPU_STATUS_SUCCESS;
}

tfqmrgpuStatus_t tfqmrgpuDestroyWorkspace(void* pBuffer) {
    (void)pBuffer;
    return TFQMRGPU_STATUS_SUCCESS;
}

/* ------------------------------------------------------ introspection -- */

tfqmrgpuStatus_t tfqmrgpu_bsrsv_allowedBlockSizes(int32_t* number,
                                                  int32_t* blockSizes,
                                                  int arrayLength) {
    return as_status(call_bridge("allowed_block_sizes", "(LLi)",
                                 (long long)addr(number),
                                 (long long)addr(blockSizes), arrayLength));
}

tfqmrgpuStatus_t tfqmrgpu_bsrsv_blockSizeMissing(int ldA, int ldB) {
    return as_status(call_bridge("block_size_missing", "(ii)", ldA, ldB));
}

/* --------------------------------------------------------------- plan -- */

tfqmrgpuStatus_t tfqmrgpu_bsrsv_createPlan(tfqmrgpuHandle_t handle,
    tfqmrgpuBsrsvPlan_t* plan, int mb,
    const int32_t* bsrRowPtrA, int nnzbA, const int32_t* bsrColIndA,
    const int32_t* bsrRowPtrX, int nnzbX, const int32_t* bsrColIndX,
    const int32_t* bsrRowPtrB, int nnzbB, const int32_t* bsrColIndB,
    int indexOffset, int echo) {
    if (plan == nullptr) return TFQMRGPU_POINTER_INVALID;
    const int64_t v = call_bridge(
        "plan_create", "(LiLiLLiLLiLii)", (long long)handle, mb,
        (long long)addr(bsrRowPtrA), nnzbA, (long long)addr(bsrColIndA),
        (long long)addr(bsrRowPtrX), nnzbX, (long long)addr(bsrColIndX),
        (long long)addr(bsrRowPtrB), nnzbB, (long long)addr(bsrColIndB),
        indexOffset, echo);
    if (v < 0) return as_status(v);
    *plan = v;
    return TFQMRGPU_STATUS_SUCCESS;
}

tfqmrgpuStatus_t tfqmrgpu_bsrsv_destroyPlan(tfqmrgpuHandle_t handle,
                                            tfqmrgpuBsrsvPlan_t plan) {
    return as_status(call_bridge("plan_destroy", "(LL)", (long long)handle,
                                 (long long)plan));
}

tfqmrgpuStatus_t tfqmrgpu_bsrsv_bufferSize(tfqmrgpuHandle_t handle,
    tfqmrgpuBsrsvPlan_t plan, int ldA, int blockDim, int ldB,
    int RhsBlockDim, char precision, size_t* pBufferSizeInBytes) {
    const int64_t v = call_bridge("buffer_size", "(LLiiiii)",
                                  (long long)handle, (long long)plan, ldA,
                                  blockDim, ldB, RhsBlockDim, (int)precision);
    if (v < 0) return as_status(v);
    if (pBufferSizeInBytes != nullptr) *pBufferSizeInBytes = (size_t)v;
    return TFQMRGPU_STATUS_SUCCESS;
}

tfqmrgpuStatus_t tfqmrgpu_bsrsv_setBuffer(tfqmrgpuHandle_t handle,
                                          tfqmrgpuBsrsvPlan_t plan,
                                          void* pBuffer) {
    return as_status(call_bridge("set_buffer", "(LLL)", (long long)handle,
                                 (long long)plan, (long long)addr(pBuffer)));
}

tfqmrgpuStatus_t tfqmrgpu_bsrsv_getBuffer(tfqmrgpuHandle_t handle,
                                          tfqmrgpuBsrsvPlan_t plan,
                                          void** pBuffer) {
    int64_t token = 0;
    const int64_t v = call_bridge("get_buffer", "(LLL)", (long long)handle,
                                  (long long)plan, (long long)addr(&token));
    if (v < 0) return as_status(v);
    if (pBuffer != nullptr)
        *pBuffer = reinterpret_cast<void*>(static_cast<uintptr_t>(token));
    return TFQMRGPU_STATUS_SUCCESS;
}

/* ------------------------------------------------------------ matrices -- */

tfqmrgpuStatus_t tfqmrgpu_bsrsv_setMatrix(tfqmrgpuHandle_t handle,
    tfqmrgpuBsrsvPlan_t plan, char var, const void* val, char precision,
    int ld, int d2, char trans, tfqmrgpuDataLayout_t layout) {
    return as_status(call_bridge("set_matrix", "(LLiLiiiii)",
                                 (long long)handle, (long long)plan, (int)var,
                                 (long long)addr(val), (int)precision, ld, d2,
                                 (int)trans, (int)layout));
}

tfqmrgpuStatus_t tfqmrgpu_bsrsv_getMatrix(tfqmrgpuHandle_t handle,
    tfqmrgpuBsrsvPlan_t plan, char var, void* val, char precision,
    int ld, int d2, char trans, tfqmrgpuDataLayout_t layout) {
    return as_status(call_bridge("get_matrix", "(LLiLiiiii)",
                                 (long long)handle, (long long)plan, (int)var,
                                 (long long)addr(val), (int)precision, ld, d2,
                                 (int)trans, (int)layout));
}

/* --------------------------------------------------------------- solve -- */

tfqmrgpuStatus_t tfqmrgpu_bsrsv_solve(tfqmrgpuHandle_t handle,
                                      tfqmrgpuBsrsvPlan_t plan,
                                      double threshold, int maxIterations) {
    return as_status(call_bridge("solve", "(LLdi)", (long long)handle,
                                 (long long)plan, threshold, maxIterations));
}

tfqmrgpuStatus_t tfqmrgpu_bsrsv_getInfo(tfqmrgpuHandle_t handle,
    tfqmrgpuBsrsvPlan_t plan, double* residuum_reached,
    int32_t* iterations_needed, double* flops_performed,
    double* flops_performed_all) {
    return as_status(call_bridge(
        "get_info", "(LLLLLL)", (long long)handle, (long long)plan,
        (long long)addr(residuum_reached), (long long)addr(iterations_needed),
        (long long)addr(flops_performed),
        (long long)addr(flops_performed_all)));
}

/* ------------------------------------------------- one-call wrappers -- */

tfqmrgpuStatus_t tfqmrgpu_bsrsv_z(int mb, int ldA, int ldB,
    const int32_t* rowPtrA, int nnzbA, const int32_t* colIndA,
    const double* Amat, char transA,
    const int32_t* rowPtrX, int nnzbX, const int32_t* colIndX,
    double* Xmat, char transX,
    const int32_t* rowPtrB, int nnzbB, const int32_t* colIndB,
    const double* Bmat, char transB,
    int32_t* iterations, float* residual, int indexOffset, int echo) {
    return as_status(call_bridge(
        "bsrsv_z", "(iiiLiLLiLiLLiLiLLiLLii)", mb, ldA, ldB,
        (long long)addr(rowPtrA), nnzbA, (long long)addr(colIndA),
        (long long)addr(Amat), (int)transA,
        (long long)addr(rowPtrX), nnzbX, (long long)addr(colIndX),
        (long long)addr(Xmat), (int)transX,
        (long long)addr(rowPtrB), nnzbB, (long long)addr(colIndB),
        (long long)addr(Bmat), (int)transB,
        (long long)addr(iterations), (long long)addr(residual),
        indexOffset, echo));
}

tfqmrgpuStatus_t tfqmrgpu_bsrsv_c(int mb, int ldA, int ldB,
    const int32_t* rowPtrA, int nnzbA, const int32_t* colIndA,
    const float* Amat, char transA,
    const int32_t* rowPtrX, int nnzbX, const int32_t* colIndX,
    float* Xmat, char transX,
    const int32_t* rowPtrB, int nnzbB, const int32_t* colIndB,
    const float* Bmat, char transB,
    int32_t* iterations, float* residual, int indexOffset, int echo) {
    return as_status(call_bridge(
        "bsrsv_c", "(iiiLiLLiLiLLiLiLLiLLii)", mb, ldA, ldB,
        (long long)addr(rowPtrA), nnzbA, (long long)addr(colIndA),
        (long long)addr(Amat), (int)transA,
        (long long)addr(rowPtrX), nnzbX, (long long)addr(colIndX),
        (long long)addr(Xmat), (int)transX,
        (long long)addr(rowPtrB), nnzbB, (long long)addr(colIndB),
        (long long)addr(Bmat), (int)transB,
        (long long)addr(iterations), (long long)addr(residual),
        indexOffset, echo));
}

tfqmrgpuStatus_t tfqmrgpu_bsrsv_m(int mb, int ldA, int ldB,
    const int32_t* rowPtrA, int nnzbA, const int32_t* colIndA,
    const double* Amat, char transA,
    const int32_t* rowPtrX, int nnzbX, const int32_t* colIndX,
    double* Xmat, char transX,
    const int32_t* rowPtrB, int nnzbB, const int32_t* colIndB,
    const double* Bmat, char transB,
    int32_t* iterations, float* residual, int indexOffset, int echo) {
    return as_status(call_bridge(
        "bsrsv_m", "(iiiLiLLiLiLLiLiLLiLLii)", mb, ldA, ldB,
        (long long)addr(rowPtrA), nnzbA, (long long)addr(colIndA),
        (long long)addr(Amat), (int)transA,
        (long long)addr(rowPtrX), nnzbX, (long long)addr(colIndX),
        (long long)addr(Xmat), (int)transX,
        (long long)addr(rowPtrB), nnzbB, (long long)addr(colIndB),
        (long long)addr(Bmat), (int)transB,
        (long long)addr(iterations), (long long)addr(residual),
        indexOffset, echo));
}

}  // extern "C"
