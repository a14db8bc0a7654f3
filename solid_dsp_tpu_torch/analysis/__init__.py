"""Filter analysis: spectral estimation (torch), group delay and frequency
response (host float64)."""

from .freq_response import (  # noqa: F401
    fir_frequency_response, frequency_response_band,
    iir_frequency_response, iir_frequency_response_band)
from .group_delay import (  # noqa: F401
    fir_group_delay, fir_group_delay_band, iir_group_delay)
from .spectral import (  # noqa: F401
    analytic_signal, cepstrum, coherence, csd, envelope, frame_signal,
    goertzel_bank, instantaneous_frequency, istft, spectrogram, stft,
    stft_denoise, welch_psd)
