"""Host utilities: WAV file I/O."""
