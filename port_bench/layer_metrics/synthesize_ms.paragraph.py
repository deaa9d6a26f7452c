"""Mean ms a request of the benchmark's span around the synthesizer's
``synthesize_spectrograms`` (the call returns host mels, so the span ends
after the device)."""


def read(run):
    return run.span_mean_ms("synthesize")
