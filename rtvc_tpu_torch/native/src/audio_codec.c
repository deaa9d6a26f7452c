/* Native audio decode/encode shim over the system FFmpeg libraries.
 *
 * Replaces the reference's librosa/audioread + ffmpeg-subprocess audio IO
 * (ref: encoder/audio.py:22-30, scripts/convert.sh, scripts/
 * commonvoice_transcript.py ffmpeg calls) with an in-process path:
 *   - rtvc_decode_audio: any container/codec FFmpeg knows (flac, mp3, m4a,
 *     ogg/vorbis/opus, NIST sph, wav, ...) -> mono float32 PCM, optionally
 *     resampled to target_sr by libswresample.
 *   - rtvc_encode_audio: mono float32 PCM -> file, codec/container chosen
 *     from the output extension (flac/mp3/ogg/wav).
 *
 * Exposed to Python through ctypes (rtvc_tpu_torch/utils/libav.py). Plain C API,
 * no Python dependency here.
 */
#include <stdint.h>
#include <stdio.h>
#include <stdlib.h>
#include <string.h>

#include <libavcodec/avcodec.h>
#include <libavformat/avformat.h>
#include <libavutil/audio_fifo.h>
#include <libavutil/channel_layout.h>
#include <libavutil/opt.h>
#include <libswresample/swresample.h>

#define ERR(fmt, ...)                                            \
    do {                                                         \
        if (err && errlen > 0)                                   \
            snprintf(err, (size_t)errlen, fmt, ##__VA_ARGS__);   \
    } while (0)

void rtvc_free_buf(void *p) { av_free(p); }

const char *rtvc_codec_version(void) { return av_version_info(); }

/* Decode an audio file to mono float32.
 * target_sr == 0 keeps the native sample rate.
 * On success returns 0 and sets *out_data (av_malloc'd, free with
 * rtvc_free_buf), *out_n (samples) and *out_sr. On failure returns <0 and
 * writes a message into err. */
int rtvc_decode_audio(const char *path, int target_sr, float **out_data,
                      int64_t *out_n, int *out_sr, char *err, int errlen) {
    AVFormatContext *fmt = NULL;
    AVCodecContext *dec = NULL;
    SwrContext *swr = NULL;
    AVPacket *pkt = NULL;
    AVFrame *frame = NULL;
    float *buf = NULL;
    int64_t cap = 0, n = 0;
    int ret = -1, stream_idx = -1, sr = 0;

    if (avformat_open_input(&fmt, path, NULL, NULL) < 0) {
        ERR("cannot open %s", path);
        return -1;
    }
    if (avformat_find_stream_info(fmt, NULL) < 0) {
        ERR("no stream info in %s", path);
        goto done;
    }
    const AVCodec *codec = NULL;
    stream_idx = av_find_best_stream(fmt, AVMEDIA_TYPE_AUDIO, -1, -1, &codec, 0);
    if (stream_idx < 0 || !codec) {
        ERR("no audio stream in %s", path);
        goto done;
    }
    AVStream *st = fmt->streams[stream_idx];
    dec = avcodec_alloc_context3(codec);
    if (!dec || avcodec_parameters_to_context(dec, st->codecpar) < 0 ||
        avcodec_open2(dec, codec, NULL) < 0) {
        ERR("cannot open decoder %s", codec->name);
        goto done;
    }

    sr = target_sr > 0 ? target_sr : dec->sample_rate;
    {
        AVChannelLayout mono = AV_CHANNEL_LAYOUT_MONO;
        AVChannelLayout in_layout;
        if (dec->ch_layout.nb_channels > 0)
            av_channel_layout_copy(&in_layout, &dec->ch_layout);
        else
            av_channel_layout_default(&in_layout, 1);
        if (swr_alloc_set_opts2(&swr, &mono, AV_SAMPLE_FMT_FLT, sr, &in_layout,
                                dec->sample_fmt, dec->sample_rate, 0, NULL) < 0) {
            ERR("cannot init resampler");
            av_channel_layout_uninit(&in_layout);
            goto done;
        }
        /* Downmix as the per-channel MEAN (librosa mono semantics, which the
         * reference load path uses — ref encoder/audio.py:22-30), not swr's
         * default power-preserving (L+R)/sqrt(2). */
        if (in_layout.nb_channels > 1) {
            double matrix[64];
            for (int i = 0; i < in_layout.nb_channels && i < 64; i++)
                matrix[i] = 1.0 / in_layout.nb_channels;
            swr_set_matrix(swr, matrix, in_layout.nb_channels);
        }
        if (swr_init(swr) < 0) {
            ERR("cannot init resampler");
            av_channel_layout_uninit(&in_layout);
            goto done;
        }
        av_channel_layout_uninit(&in_layout);
    }

    pkt = av_packet_alloc();
    frame = av_frame_alloc();
    if (!pkt || !frame) {
        ERR("alloc failure");
        goto done;
    }

    int draining = 0;
    while (1) {
        if (!draining) {
            int r = av_read_frame(fmt, pkt);
            if (r < 0) {
                draining = 1;
                avcodec_send_packet(dec, NULL);
            } else if (pkt->stream_index != stream_idx) {
                av_packet_unref(pkt);
                continue;
            } else {
                avcodec_send_packet(dec, pkt);
                av_packet_unref(pkt);
            }
        }
        int r = avcodec_receive_frame(dec, frame);
        if (r == AVERROR(EAGAIN)) {
            if (draining) break;
            continue;
        }
        if (r == AVERROR_EOF) break;
        if (r < 0) {
            ERR("decode error in %s", path);
            goto done;
        }
        int64_t max_out =
            swr_get_out_samples(swr, frame->nb_samples) + 256;
        if (n + max_out > cap) {
            cap = (n + max_out) * 2 + 4096;
            float *nb = av_realloc(buf, (size_t)cap * sizeof(float));
            if (!nb) {
                ERR("out of memory");
                goto done;
            }
            buf = nb;
        }
        uint8_t *outp = (uint8_t *)(buf + n);
        int got = swr_convert(swr, &outp, (int)(cap - n),
                              (const uint8_t **)frame->extended_data,
                              frame->nb_samples);
        if (got < 0) {
            ERR("resample error");
            goto done;
        }
        n += got;
        av_frame_unref(frame);
    }
    /* flush the resampler */
    while (1) {
        if (n + 4096 > cap) {
            cap = n + 8192;
            float *nb = av_realloc(buf, (size_t)cap * sizeof(float));
            if (!nb) {
                ERR("out of memory");
                goto done;
            }
            buf = nb;
        }
        uint8_t *outp = (uint8_t *)(buf + n);
        int got = swr_convert(swr, &outp, (int)(cap - n), NULL, 0);
        if (got <= 0) break;
        n += got;
    }

    *out_data = buf;
    *out_n = n;
    *out_sr = sr;
    buf = NULL; /* ownership to caller */
    ret = 0;

done:
    if (buf) av_free(buf);
    if (frame) av_frame_free(&frame);
    if (pkt) av_packet_free(&pkt);
    if (swr) swr_free(&swr);
    if (dec) avcodec_free_context(&dec);
    if (fmt) avformat_close_input(&fmt);
    return ret;
}

/* Encode mono float32 PCM to a file; container + codec guessed from the
 * output extension (.flac, .mp3, .ogg, .wav, ...). Returns 0 on success. */
int rtvc_encode_audio(const char *path, const float *pcm, int64_t n, int sr,
                      char *err, int errlen) {
    AVFormatContext *fmt = NULL;
    AVCodecContext *enc = NULL;
    SwrContext *swr = NULL;
    AVAudioFifo *fifo = NULL;
    AVFrame *frame = NULL;
    AVPacket *pkt = NULL;
    int ret = -1;

    if (avformat_alloc_output_context2(&fmt, NULL, NULL, path) < 0 || !fmt) {
        ERR("no muxer for %s", path);
        return -1;
    }
    const AVCodec *codec = avcodec_find_encoder(fmt->oformat->audio_codec);
    if (!codec) {
        ERR("no encoder for %s", path);
        goto done;
    }
    enc = avcodec_alloc_context3(codec);
    if (!enc) {
        ERR("alloc failure");
        goto done;
    }
    /* pick a sample format the encoder supports */
    enc->sample_fmt = AV_SAMPLE_FMT_FLT;
    if (codec->sample_fmts) {
        enc->sample_fmt = codec->sample_fmts[0];
        for (const enum AVSampleFormat *f = codec->sample_fmts;
             *f != AV_SAMPLE_FMT_NONE; f++)
            if (*f == AV_SAMPLE_FMT_FLT || *f == AV_SAMPLE_FMT_FLTP) {
                enc->sample_fmt = *f;
                break;
            }
    }
    enc->sample_rate = sr;
    av_channel_layout_default(&enc->ch_layout, 1);
    enc->time_base = (AVRational){1, sr};
    if (fmt->oformat->flags & AVFMT_GLOBALHEADER)
        enc->flags |= AV_CODEC_FLAG_GLOBAL_HEADER;
    if (avcodec_open2(enc, codec, NULL) < 0) {
        ERR("cannot open encoder %s", codec->name);
        goto done;
    }

    AVStream *st = avformat_new_stream(fmt, NULL);
    if (!st || avcodec_parameters_from_context(st->codecpar, enc) < 0) {
        ERR("stream setup failed");
        goto done;
    }
    st->time_base = enc->time_base;

    if (!(fmt->oformat->flags & AVFMT_NOFILE) &&
        avio_open(&fmt->pb, path, AVIO_FLAG_WRITE) < 0) {
        ERR("cannot write %s", path);
        goto done;
    }
    if (avformat_write_header(fmt, NULL) < 0) {
        ERR("cannot write header");
        goto done;
    }

    /* input float mono -> encoder sample_fmt via swr */
    {
        AVChannelLayout mono = AV_CHANNEL_LAYOUT_MONO;
        if (swr_alloc_set_opts2(&swr, &mono, enc->sample_fmt, sr, &mono,
                                AV_SAMPLE_FMT_FLT, sr, 0, NULL) < 0 ||
            swr_init(swr) < 0) {
            ERR("cannot init converter");
            goto done;
        }
    }
    fifo = av_audio_fifo_alloc(enc->sample_fmt, 1, 4096);
    pkt = av_packet_alloc();
    frame = av_frame_alloc();
    if (!fifo || !pkt || !frame) {
        ERR("alloc failure");
        goto done;
    }

    int frame_size = enc->frame_size > 0 ? enc->frame_size : 4096;
    int64_t pos = 0, pts = 0;
    uint8_t *tmp[1];
    int tmp_cap = frame_size * 4;
    if (av_samples_alloc(tmp, NULL, 1, tmp_cap, enc->sample_fmt, 0) < 0) {
        ERR("alloc failure");
        goto done;
    }

    int done_in = 0;
    while (!done_in || av_audio_fifo_size(fifo) > 0) {
        if (!done_in) {
            int chunk = (int)(n - pos < tmp_cap ? n - pos : tmp_cap);
            if (chunk > 0) {
                const uint8_t *inp = (const uint8_t *)(pcm + pos);
                int got = swr_convert(swr, tmp, tmp_cap, &inp, chunk);
                if (got < 0) {
                    ERR("convert error");
                    av_freep(&tmp[0]);
                    goto done;
                }
                av_audio_fifo_write(fifo, (void **)tmp, got);
                pos += chunk;
            }
            if (pos >= n) done_in = 1;
        }
        while (av_audio_fifo_size(fifo) >= frame_size ||
               (done_in && av_audio_fifo_size(fifo) > 0)) {
            int take = av_audio_fifo_size(fifo) < frame_size
                           ? av_audio_fifo_size(fifo)
                           : frame_size;
            frame->nb_samples = take;
            av_channel_layout_default(&frame->ch_layout, 1);
            frame->format = enc->sample_fmt;
            frame->sample_rate = sr;
            if (av_frame_get_buffer(frame, 0) < 0) {
                ERR("frame alloc failed");
                av_freep(&tmp[0]);
                goto done;
            }
            av_audio_fifo_read(fifo, (void **)frame->data, take);
            frame->pts = pts;
            pts += take;
            avcodec_send_frame(enc, frame);
            av_frame_unref(frame);
            while (avcodec_receive_packet(enc, pkt) == 0) {
                av_packet_rescale_ts(pkt, enc->time_base, st->time_base);
                pkt->stream_index = st->index;
                av_interleaved_write_frame(fmt, pkt);
            }
        }
    }
    av_freep(&tmp[0]);
    /* drain the encoder */
    avcodec_send_frame(enc, NULL);
    while (avcodec_receive_packet(enc, pkt) == 0) {
        av_packet_rescale_ts(pkt, enc->time_base, st->time_base);
        pkt->stream_index = st->index;
        av_interleaved_write_frame(fmt, pkt);
    }
    av_write_trailer(fmt);
    ret = 0;

done:
    if (frame) av_frame_free(&frame);
    if (pkt) av_packet_free(&pkt);
    if (fifo) av_audio_fifo_free(fifo);
    if (swr) swr_free(&swr);
    if (enc) avcodec_free_context(&enc);
    if (fmt) {
        if (!(fmt->oformat->flags & AVFMT_NOFILE) && fmt->pb)
            avio_closep(&fmt->pb);
        avformat_free_context(fmt);
    }
    return ret;
}
