// Native video I/O with a prefetch ring, counterpart of
// tracking_tpu/native/videoio.cpp (the same code): the reference's
// VideoCapture runtime (VideoCapture.cpp:93-242: file/camera source,
// resize, flip, per-frame loop) with the demux/decode/scale chain (FFmpeg:
// libavformat/libavcodec/libswscale) on a background thread filling a
// bounded ring of BGR24 frame buffers, so the host loop only copies batches
// out while the card computes.
//
// C ABI (ctypes-friendly):
//   void* vio_open(const char* path, int target_w, int target_h, int flip);
//   int   vio_info(void* h, int* w, int* h_, double* fps);
//   long  vio_read_batch(void* h, unsigned char* out, long max_frames);
//   void  vio_close(void* h);
//
// Encoder counterpart (the reference writes its fgavi/btavi/output AVIs
// through cv::VideoWriter with the MJPG fourcc, trackingMain.cpp:168-215;
// this is the same container+codec via libavformat/libavcodec directly):
//   void* vio_writer_open(const char* path, int w, int h, double fps);
//   int   vio_writer_write(void* h, const unsigned char* bgr, long n);
//   int   vio_writer_close(void* h);   // flushes + writes the trailer
//
// Build: tracking_tpu_torch/native/__init__.py:build (g++ -O2 -shared -fPIC,
// links avformat/avcodec/avutil/swscale) at first use; io/video.py reads
// through cv2 where the compiler or FFmpeg's headers are missing.

#include <atomic>
#include <condition_variable>
#include <cstdio>
#include <cstring>
#include <deque>
#include <mutex>
#include <thread>
#include <vector>

extern "C" {
#include <libavcodec/avcodec.h>
#include <libavformat/avformat.h>
#include <libavutil/imgutils.h>
#include <libswscale/swscale.h>
}

namespace {

struct Frame {
  std::vector<unsigned char> data;  // BGR24, h*w*3
};

struct Vio {
  AVFormatContext* fmt = nullptr;
  AVCodecContext* dec = nullptr;
  SwsContext* sws = nullptr;
  int stream_idx = -1;
  int src_w = 0, src_h = 0;
  int out_w = 0, out_h = 0;
  int flip = 0;
  double fps = 0.0;

  std::thread worker;
  std::mutex mu;
  std::condition_variable cv_pop, cv_push;
  std::deque<Frame> ring;
  size_t ring_cap = 64;
  std::atomic<bool> eof{false};
  std::atomic<bool> stop{false};

  ~Vio() {
    stop = true;
    cv_push.notify_all();
    cv_pop.notify_all();
    if (worker.joinable()) worker.join();
    if (sws) sws_freeContext(sws);
    if (dec) avcodec_free_context(&dec);
    if (fmt) avformat_close_input(&fmt);
  }
};

void push_frame(Vio* v, AVFrame* fr) {
  Frame out;
  out.data.resize((size_t)v->out_w * v->out_h * 3);
  uint8_t* dst[1] = {out.data.data()};
  int dst_stride[1] = {v->out_w * 3};
  sws_scale(v->sws, fr->data, fr->linesize, 0, v->src_h, dst, dst_stride);
  if (v->flip) {  // horizontal flip (VideoCapture.cpp flip option)
    for (int y = 0; y < v->out_h; ++y) {
      unsigned char* row = out.data.data() + (size_t)y * v->out_w * 3;
      for (int x = 0; x < v->out_w / 2; ++x) {
        for (int c = 0; c < 3; ++c)
          std::swap(row[x * 3 + c], row[(v->out_w - 1 - x) * 3 + c]);
      }
    }
  }
  std::unique_lock<std::mutex> lk(v->mu);
  v->cv_push.wait(lk, [v] { return v->ring.size() < v->ring_cap || v->stop; });
  if (v->stop) return;
  v->ring.push_back(std::move(out));
  v->cv_pop.notify_one();
}

void decode_loop(Vio* v) {
  AVPacket* pkt = av_packet_alloc();
  AVFrame* fr = av_frame_alloc();
  while (!v->stop && av_read_frame(v->fmt, pkt) >= 0) {
    if (pkt->stream_index == v->stream_idx) {
      if (avcodec_send_packet(v->dec, pkt) >= 0) {
        while (!v->stop && avcodec_receive_frame(v->dec, fr) >= 0)
          push_frame(v, fr);
      }
    }
    av_packet_unref(pkt);
  }
  // drain
  avcodec_send_packet(v->dec, nullptr);
  while (!v->stop && avcodec_receive_frame(v->dec, fr) >= 0) push_frame(v, fr);
  av_frame_free(&fr);
  av_packet_free(&pkt);
  v->eof = true;
  v->cv_pop.notify_all();
}

}  // namespace

extern "C" {

void* vio_open(const char* path, int target_w, int target_h, int flip) {
  auto* v = new Vio();
  if (avformat_open_input(&v->fmt, path, nullptr, nullptr) < 0) {
    delete v;
    return nullptr;
  }
  if (avformat_find_stream_info(v->fmt, nullptr) < 0) {
    delete v;
    return nullptr;
  }
  const AVCodec* codec = nullptr;
  v->stream_idx =
      av_find_best_stream(v->fmt, AVMEDIA_TYPE_VIDEO, -1, -1, &codec, 0);
  if (v->stream_idx < 0 || !codec) {
    delete v;
    return nullptr;
  }
  AVStream* st = v->fmt->streams[v->stream_idx];
  v->dec = avcodec_alloc_context3(codec);
  avcodec_parameters_to_context(v->dec, st->codecpar);
  if (avcodec_open2(v->dec, codec, nullptr) < 0) {
    delete v;
    return nullptr;
  }
  v->src_w = v->dec->width;
  v->src_h = v->dec->height;
  v->out_w = target_w > 0 ? target_w : v->src_w;
  v->out_h = target_h > 0 ? target_h : v->src_h;
  v->flip = flip;
  AVRational r = st->avg_frame_rate;
  v->fps = r.den ? (double)r.num / r.den : 0.0;
  v->sws = sws_getContext(v->src_w, v->src_h, v->dec->pix_fmt, v->out_w,
                          v->out_h, AV_PIX_FMT_BGR24, SWS_BILINEAR, nullptr,
                          nullptr, nullptr);
  if (!v->sws) {
    delete v;
    return nullptr;
  }
  v->worker = std::thread(decode_loop, v);
  return v;
}

int vio_info(void* h, int* w, int* h_, double* fps) {
  auto* v = (Vio*)h;
  if (!v) return -1;
  *w = v->out_w;
  *h_ = v->out_h;
  *fps = v->fps;
  return 0;
}

long vio_read_batch(void* h, unsigned char* out, long max_frames) {
  auto* v = (Vio*)h;
  if (!v) return -1;
  const size_t frame_bytes = (size_t)v->out_w * v->out_h * 3;
  long n = 0;
  while (n < max_frames) {
    std::unique_lock<std::mutex> lk(v->mu);
    v->cv_pop.wait(lk, [v] { return !v->ring.empty() || v->eof || v->stop; });
    if (v->ring.empty()) break;  // eof
    Frame fr = std::move(v->ring.front());
    v->ring.pop_front();
    v->cv_push.notify_one();
    lk.unlock();
    std::memcpy(out + (size_t)n * frame_bytes, fr.data.data(), frame_bytes);
    ++n;
  }
  return n;
}

void vio_close(void* h) { delete (Vio*)h; }

}  // extern "C"

// ---------------------------------------------------------------------------
// Encoder: BGR24 frames -> MJPEG-in-AVI (cv::VideoWriter MJPG parity).
// ---------------------------------------------------------------------------

namespace {

struct Vw {
  AVFormatContext* fmt = nullptr;
  AVStream* st = nullptr;
  AVCodecContext* enc = nullptr;
  SwsContext* sws = nullptr;
  AVFrame* yuv = nullptr;
  AVPacket* pkt = nullptr;
  int w = 0, h = 0;
  long n = 0;
  bool open = false;
};

void vw_free(Vw* v) {
  if (v->pkt) av_packet_free(&v->pkt);
  if (v->yuv) av_frame_free(&v->yuv);
  if (v->sws) sws_freeContext(v->sws);
  if (v->enc) avcodec_free_context(&v->enc);
  if (v->fmt) {
    if (v->fmt->pb) avio_closep(&v->fmt->pb);
    avformat_free_context(v->fmt);
  }
  delete v;
}

int vw_send(Vw* v, AVFrame* fr) {
  if (avcodec_send_frame(v->enc, fr) < 0) return -1;
  while (true) {
    int r = avcodec_receive_packet(v->enc, v->pkt);
    if (r == AVERROR(EAGAIN) || r == AVERROR_EOF) break;
    if (r < 0) return -1;
    av_packet_rescale_ts(v->pkt, v->enc->time_base, v->st->time_base);
    v->pkt->stream_index = v->st->index;
    if (av_interleaved_write_frame(v->fmt, v->pkt) < 0) return -1;
  }
  return 0;
}

}  // namespace

extern "C" {

void* vio_writer_open(const char* path, int w, int h, double fps) {
  // swscale warns about the (JPEG full-range) YUVJ420P alias every call;
  // the range IS set correctly — keep the log at error level.
  av_log_set_level(AV_LOG_ERROR);
  auto* v = new Vw();
  v->w = w;
  v->h = h;
  if (avformat_alloc_output_context2(&v->fmt, nullptr, "avi", path) < 0) {
    vw_free(v);
    return nullptr;
  }
  const AVCodec* codec = avcodec_find_encoder(AV_CODEC_ID_MJPEG);
  if (!codec) {
    vw_free(v);
    return nullptr;
  }
  v->st = avformat_new_stream(v->fmt, nullptr);
  v->enc = avcodec_alloc_context3(codec);
  if (!v->st || !v->enc) {
    vw_free(v);
    return nullptr;
  }
  AVRational fr = av_d2q(fps > 0 ? fps : 30.0, 1000000);
  v->enc->codec_id = AV_CODEC_ID_MJPEG;
  v->enc->width = w;
  v->enc->height = h;
  v->enc->time_base = AVRational{fr.den, fr.num};
  v->enc->framerate = fr;
  v->enc->pix_fmt = AV_PIX_FMT_YUVJ420P;  // full-range, the MJPEG native fmt
  v->enc->color_range = AVCOL_RANGE_JPEG;
  // cv::VideoWriter's default MJPG quality is ~95%; qscale 2-3 is comparable
  v->enc->flags |= AV_CODEC_FLAG_QSCALE;
  v->enc->global_quality = FF_QP2LAMBDA * 3;
  if (v->fmt->oformat->flags & AVFMT_GLOBALHEADER)
    v->enc->flags |= AV_CODEC_FLAG_GLOBAL_HEADER;
  if (avcodec_open2(v->enc, codec, nullptr) < 0 ||
      avcodec_parameters_from_context(v->st->codecpar, v->enc) < 0) {
    vw_free(v);
    return nullptr;
  }
  v->st->time_base = v->enc->time_base;
  if (avio_open(&v->fmt->pb, path, AVIO_FLAG_WRITE) < 0 ||
      avformat_write_header(v->fmt, nullptr) < 0) {
    vw_free(v);
    return nullptr;
  }
  v->sws = sws_getContext(w, h, AV_PIX_FMT_BGR24, w, h, AV_PIX_FMT_YUVJ420P,
                          SWS_BILINEAR, nullptr, nullptr, nullptr);
  v->yuv = av_frame_alloc();
  v->pkt = av_packet_alloc();
  if (!v->sws || !v->yuv || !v->pkt) {
    vw_free(v);
    return nullptr;
  }
  v->yuv->format = AV_PIX_FMT_YUVJ420P;
  v->yuv->width = w;
  v->yuv->height = h;
  if (av_frame_get_buffer(v->yuv, 0) < 0) {
    vw_free(v);
    return nullptr;
  }
  v->open = true;
  return v;
}

int vio_writer_write(void* h, const unsigned char* bgr, long n_frames) {
  auto* v = (Vw*)h;
  if (!v || !v->open) return -1;
  const size_t frame_bytes = (size_t)v->w * v->h * 3;
  for (long i = 0; i < n_frames; ++i) {
    const uint8_t* src[1] = {bgr + (size_t)i * frame_bytes};
    int src_stride[1] = {v->w * 3};
    if (av_frame_make_writable(v->yuv) < 0) return -1;
    sws_scale(v->sws, src, src_stride, 0, v->h, v->yuv->data, v->yuv->linesize);
    v->yuv->pts = v->n++;
    v->yuv->quality = v->enc->global_quality;
    if (vw_send(v, v->yuv) < 0) return -1;
  }
  return 0;
}

int vio_writer_close(void* h) {
  auto* v = (Vw*)h;
  if (!v) return -1;
  int rc = 0;
  if (v->open) {
    if (vw_send(v, nullptr) < 0) rc = -1;  // flush the encoder
    if (av_write_trailer(v->fmt) < 0) rc = -1;
  }
  vw_free(v);
  return rc;
}

}  // extern "C"
