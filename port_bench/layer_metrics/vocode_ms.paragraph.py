"""Mean ms a request of the benchmark's span around the vocoder call
(``infer_waveform`` / ``infer_waveforms``, which return host
waveforms)."""


def read(run):
    return run.span_mean_ms("vocode")
