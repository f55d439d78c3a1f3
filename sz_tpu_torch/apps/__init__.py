"""Application-specific codecs: ExaFEL, PaSTRI and the wavelet
pre-transform."""
