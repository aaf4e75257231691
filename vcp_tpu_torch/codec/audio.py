"""Audio of an encode: AAC passthrough, AAC re-encode, PCM encode, and
audio-only output.

Copy of ``vcp_tpu/codec/audio.py``. An MP4 / MKV input's AAC track is
demuxed (AudioSpecificConfig and raw access units) and either passed
through (``-c:a copy``, or no bitrate) or decoded and encoded again at
``-b:a N`` (``codec.aac_decode``, ``codec.aac``); WAV and AVI sources of
16-bit PCM are AAC-LC encoded. As in ``vcp_tpu``, a re-encode that raises
passes the source track through. :func:`extract_audio` is ``-vn``: an MP4
of the audio track alone.
"""

from __future__ import annotations

import os

from . import mp4 as m


class AudioError(RuntimeError):
    pass


def extract_aac_track(input_path: str) -> m.AudioTrack | None:
    """Demux the input's AAC track into an mp4 AudioTrack (passthrough),
    or None if the input has no AAC audio."""
    ext = os.path.splitext(input_path)[1].lower()
    if ext in (".mp4", ".mov", ".m4v"):
        demux = m.Mp4Demuxer(input_path)
        t = demux.audio
        if t is None or t.codec != "mp4a":
            return None
        out = m.AudioTrack(codec="aac", sample_rate=t.sample_rate or 48000,
                           channels=t.channels or 2,
                           timescale=t.timescale or t.sample_rate or 48000,
                           decoder_config=t.decoder_config)
        for i in range(t.sample_count):
            dur = (t.sample_durations[i]
                   if i < len(t.sample_durations) else 1024)
            out.samples.append(m.Sample(data=demux.sample(t, i),
                                        duration=dur, is_sync=True))
        return out
    if ext in (".mkv", ".webm"):
        from .mkv import MkvDemuxer
        demux = MkvDemuxer(input_path)
        a = demux.audio
        if a is None or not a.codec_id.startswith("A_AAC"):
            return None
        rate = a.sample_rate or 48000
        out = m.AudioTrack(codec="aac", sample_rate=rate,
                           channels=a.channels or 2, timescale=rate,
                           decoder_config=a.codec_private)
        # AAC frame = 1024 PCM samples at timescale == sample_rate
        for s in sorted(a.samples, key=lambda x: x.timestamp_ns):
            out.samples.append(m.Sample(data=s.data, duration=1024,
                                        is_sync=True))
        return out
    return None


def encode_pcm_track(pcm, rate: int, bitrate: int = 128000) -> m.AudioTrack:
    """Encode raw PCM with the in-repo AAC-LC encoder (codec.aac) into an
    MP4 AudioTrack."""
    import numpy as np

    from .aac import AacEncoder

    pcm = np.asarray(pcm)
    channels = 1 if pcm.ndim == 1 else pcm.shape[1]
    enc = AacEncoder(rate=rate, channels=channels, bitrate=bitrate)
    track = m.AudioTrack(codec="aac", sample_rate=rate, channels=channels,
                         timescale=rate,
                         decoder_config=enc.audio_specific_config(),
                         avg_bitrate=bitrate)
    for au in enc.encode(pcm):
        track.samples.append(m.Sample(data=au, duration=1024,
                                      is_sync=True))
    return track


def reencode_aac_track(track: m.AudioTrack, bitrate: int) -> m.AudioTrack:
    """AAC → PCM → AAC at the requested bitrate (the `-c:a aac -b:a N`
    path over AAC sources, ref internal/config/config.go:44-48), using
    the in-repo AAC-LC decoder (codec.aac_decode) and encoder."""
    import numpy as np

    from .aac_decode import AacDecoder

    dec = AacDecoder(rate=track.sample_rate,
                     channels=max(1, track.channels))
    frames = [dec.decode_frame(s.data) for s in track.samples]
    if not frames:
        return track
    pcm = np.concatenate(frames, axis=0)
    pcm = np.clip(np.round(pcm), -32768, 32767).astype(np.int16)
    return encode_pcm_track(pcm, track.sample_rate, bitrate)


def audio_track_for(input_path: str, params) -> m.AudioTrack | None:
    """Best audio track for the output: AAC passthrough for `-c:a copy`
    (or when no bitrate is requested), AAC→AAC re-encode at the target
    bitrate otherwise, AAC-LC encode of raw PCM (WAV) sources."""
    br = getattr(params, "audio_bitrate", 0)
    track = extract_aac_track(input_path)
    if track is not None:
        codec = getattr(params, "audio_codec", "copy")
        if codec == "aac" and br:
            try:
                return reencode_aac_track(track, br)
            except Exception:
                return track          # unsupported AAC tool: passthrough
        return track
    from .wav import is_wav, read_wav
    if is_wav(input_path):
        pcm, rate = read_wav(input_path)
        return encode_pcm_track(pcm, rate, br or 128000)
    if input_path.lower().endswith(".avi"):
        from .avi import AviDemuxer, AviError
        try:
            a = AviDemuxer(input_path).audio
        except AviError:
            return None
        # PCM s16le (WAVEFORMATEX tag 1) → AAC-LC encode; other audio
        # codecs in AVI are out of envelope (video still transcodes).
        if a is None or a.format_tag != 1 or a.bits_per_sample != 16:
            return None
        import numpy as np
        pcm = np.frombuffer(b"".join(a.chunks), np.int16)
        if a.channels > 1:
            pcm = pcm[:pcm.size - pcm.size % a.channels]
            pcm = pcm.reshape(-1, a.channels)
        return encode_pcm_track(pcm, a.sample_rate, br or 128000)
    return None


def extract_audio(input_path: str, output_path: str, params,
                  deadline=None) -> int:
    """``-vn -c:a aac``: audio-only MP4 — AAC passthrough for AAC
    sources, in-repo AAC-LC encode for raw PCM (WAV) sources."""
    track = audio_track_for(input_path, params)
    if track is None:
        raise AudioError(
            "audio-only output requires an AAC track or raw PCM (WAV) "
            "input")
    w = m.Mp4Writer()
    w.add_track(track)
    w.write(output_path, faststart=params.faststart)
    return os.path.getsize(output_path)
