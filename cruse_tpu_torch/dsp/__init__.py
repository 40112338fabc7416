"""Signal processing of the port: windows, STFT/iSTFT, mask post-filters and chunk stitching."""
