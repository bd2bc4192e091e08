"""The ISL exchange: bandwidth-limited, compressed, staleness-tolerant
checkpoint exchange between the fleet's planes, priced into the
problem-(13) plan (the port of ``repro/isl``).

* :mod:`repro_torch.isl.link`: contact windows, rates, capacities,
  transmit energy (modular arithmetic on the pass index).
* :mod:`repro_torch.isl.codec`: delta-checkpoint compression with error
  feedback and exact wire-bit metering (int8 on kernel B1).
* :mod:`repro_torch.isl.exchange`: the async gossip and sync codec steps
  of the fleet engine, the battery charge and the NumPy oracle.

``python -m repro_torch.isl [--device cpu]`` runs the smoke (codec bits,
sync parity with the free average, async gossip against the oracles).
"""
from repro_torch.isl.codec import (CodecConfig, codec_label,
                                   delta_payload_bits, encode_delta,
                                   residual_init)
from repro_torch.isl.exchange import (EXCHANGE_MODES, ExchangeConfig,
                                      ExchangeState, async_gossip_step,
                                      exchange_events, exchange_init,
                                      null_exchange_state, oracle_exchange,
                                      staleness_weight, sync_exchange_step)
from repro_torch.isl.link import ContactConfig

__all__ = [
    "CodecConfig", "ContactConfig", "EXCHANGE_MODES", "ExchangeConfig",
    "ExchangeState", "async_gossip_step", "codec_label",
    "delta_payload_bits", "encode_delta", "exchange_events",
    "exchange_init", "null_exchange_state", "oracle_exchange",
    "residual_init", "staleness_weight", "sync_exchange_step",
]
