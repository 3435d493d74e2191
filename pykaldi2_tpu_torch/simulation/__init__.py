"""On-the-fly data simulation: reverb (RIR), additive noise, gain/speed.

Port of pykaldi2_tpu/simulation (reference behavior: pykaldi2/simulation/,
SURVEY.md §3.1 "Simulation"): sample an RIR (from a library or generated by
the image-source method), FFT-convolve, sample a noise clip + SNR and mix,
gain and speed perturbation, single- and multi-channel variants.

Two routes, as in the reference: the host-side numpy ``Simulator`` feeds the
dataset's ``simulate_fn`` hook per utterance in the loader's workers, and
the batched device route (simulation/device.py) applies reverb, noise and
gain to the waveform batch inside the train step from tensors the host
samples per row.
"""

from pykaldi2_tpu_torch.simulation.rir import image_source_rir, sample_room_rir
from pykaldi2_tpu_torch.simulation.simulator import Simulator
from pykaldi2_tpu_torch.simulation.device import (
    DeviceSimulator,
    apply_simulation,
    batch_fft_convolve,
    batch_gain_db,
    batch_mix_noise_at_snr,
    draw_simulation,
)
