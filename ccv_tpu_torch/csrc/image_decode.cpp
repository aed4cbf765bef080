// JPEG decoding from a memory buffer for ccv_tpu_torch (host code, a plain C
// ABI bound with ctypes in ccv_tpu_torch/core/native.py).
//
// Built with g++ -O3 -fPIC -shared ... -ljpeg on the first JPEG decode. The
// output is what libjpeg's default decompression gives (the settings of the
// reference's libjpeg reader): RGB for colour images, one channel for gray,
// as many components as the file has otherwise.
//
// libjpeg's default error handler calls exit(); here an error longjmps back
// and the call returns -1 with libjpeg's message. Data that ends before the
// image does (libjpeg's "premature end" warning, after which it pads the
// rest with gray) is an error too: a truncated upload is not an image.

#include <csetjmp>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>

#include <jpeglib.h>
#include <jerror.h>

namespace {

struct ErrorMgr {
    jpeg_error_mgr pub;
    jmp_buf jump;
};

void error_exit(j_common_ptr cinfo)
{
    ErrorMgr* err = reinterpret_cast<ErrorMgr*>(cinfo->err);
    longjmp(err->jump, 1);
}

void emit_message(j_common_ptr cinfo, int level)
{
    if (level < 0) {  // a warning: count it, and stop at truncated data
        cinfo->err->num_warnings++;
        if (cinfo->err->msg_code == JWRN_JPEG_EOF)
            error_exit(cinfo);
    }
}

void message(j_common_ptr cinfo, char* msg, int msg_len)
{
    char buf[JMSG_LENGTH_MAX];
    cinfo->err->format_message(cinfo, buf);
    snprintf(msg, msg_len, "%s", buf);
}

}  // namespace

extern "C" {

// Decodes `size` bytes at `data`. On success returns 0 and sets *out (free it
// with ccv_torch_free), *rows, *cols and *channels; on failure returns -1
// and writes libjpeg's message into msg (msg_len bytes at most).
int ccv_torch_decode_jpeg(const uint8_t* data, size_t size, uint8_t** out,
                          int* rows, int* cols, int* channels, char* msg,
                          int msg_len)
{
    jpeg_decompress_struct cinfo;
    ErrorMgr err;
    uint8_t* volatile buf = nullptr;
    cinfo.err = jpeg_std_error(&err.pub);
    err.pub.error_exit = error_exit;
    err.pub.emit_message = emit_message;
    if (setjmp(err.jump)) {
        message(reinterpret_cast<j_common_ptr>(&cinfo), msg, msg_len);
        jpeg_destroy_decompress(&cinfo);
        free(buf);
        return -1;
    }
    jpeg_create_decompress(&cinfo);
    jpeg_mem_src(&cinfo, data, (unsigned long)size);
    jpeg_read_header(&cinfo, TRUE);
    jpeg_start_decompress(&cinfo);
    const int w = cinfo.output_width;
    const int h = cinfo.output_height;
    const int ch = cinfo.output_components;
    buf = static_cast<uint8_t*>(malloc((size_t)w * h * ch));
    if (!buf) {
        snprintf(msg, msg_len, "out of memory for a %dx%dx%d image", h, w, ch);
        jpeg_destroy_decompress(&cinfo);
        return -1;
    }
    while ((int)cinfo.output_scanline < h) {
        uint8_t* row = buf + (size_t)cinfo.output_scanline * w * ch;
        jpeg_read_scanlines(&cinfo, &row, 1);
    }
    jpeg_finish_decompress(&cinfo);
    jpeg_destroy_decompress(&cinfo);
    *out = buf;
    *rows = h;
    *cols = w;
    *channels = ch;
    return 0;
}

void ccv_torch_free(void* p) { free(p); }

}  // extern "C"
