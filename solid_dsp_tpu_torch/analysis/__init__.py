"""Filter analysis: spectral estimation, signal quality, estimation,
linear prediction, cyclostationary analysis and RF measurements (torch),
group delay and frequency response (host float64)."""

from .freq_response import (  # noqa: F401
    fir_frequency_response, frequency_response_band,
    iir_frequency_response, iir_frequency_response_band)
from .group_delay import (  # noqa: F401
    fir_group_delay, fir_group_delay_band, iir_group_delay)
from .spectral import (  # noqa: F401
    analytic_signal, cepstrum, coherence, csd, envelope, frame_signal,
    goertzel_bank, instantaneous_frequency, istft, spectrogram, stft,
    stft_denoise, welch_psd)
from .snr import evm, noise_floor, snr_m2m4, tone_snr  # noqa: F401
from .cyclo import (  # noqa: F401
    cycle_profile, cyclic_spectrum, detect_cyclic_features,
    estimate_symbol_rate)
from .estimate import (  # noqa: F401
    tdoa_gcc_phat, tone_amplitude, tone_freq_fft, tone_freq_kay, tone_phase)
from .lpc import (  # noqa: F401
    acf, ar_psd, burg, lattice_fir, lattice_iir, levinson, lpc,
    reflection_to_poly)
from .measurements import (  # noqa: F401
    acpr, channel_power, enob, occupied_bandwidth, papr_ccdf, sfdr_db,
    sinad_db)
