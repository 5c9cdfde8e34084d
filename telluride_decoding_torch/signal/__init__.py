"""Signal preprocessing: IIR filters, resampling, audio features."""
