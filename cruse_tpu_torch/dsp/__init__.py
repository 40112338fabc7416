"""Signal processing of the port: windows and STFT/iSTFT."""
