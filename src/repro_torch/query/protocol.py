"""Reliability protocol (paper §7.2): a discrete-event model of the wire.

UDP-like channel: workers send entries with sequence numbers; the switch
keeps, per flow, the last processed SEQ X and takes part in loss recovery:

  Y == X+1 : process (prune -> ACK to worker; forward -> master ACKs)
  Y <= X   : retransmission of an already-processed packet -> forward
             WITHOUT re-processing (no double state update)
  Y >  X+1 : a gap -- drop and wait for X+1's retransmission

The key correctness property: even when pruned packets' ACKs are lost and
their retransmissions reach the master, the query result is unchanged,
because every Cheetah algorithm tolerates supersets.

This module is host code, as the JAX package's is: the protocol is a model
of packets, switches and losses, one Python step a packet, drawing its
losses from ``np.random.default_rng(seed)`` in the reference's order, so
the same seed gives the same result. The switch's pruning decisions come
in as keep masks, which the pruning engine computes on the card; a torch
mask is copied to the host once, before the loop.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass
class SwitchReliability:
    """Per-flow switch-side protocol state machine."""
    last_seq: int = -1

    def on_packet(self, seq: int, prune_fn) -> tuple[str, bool]:
        """Returns (action, processed). action: ack_prune|forward|drop."""
        if seq == self.last_seq + 1:
            self.last_seq = seq
            pruned = prune_fn(seq)
            return ("ack_prune" if pruned else "forward"), True
        if seq <= self.last_seq:
            # already processed once: forward without touching state
            return "forward", False
        return "drop", False


@dataclasses.dataclass
class MultiQuerySwitchReliability:
    """§7.2 state machine for a switch multiplexing Q concurrent queries.

    One SEQ register per flow is shared by all Q queries (the switch
    processes each packet once through every query's pipeline stage). A
    packet is ACK-pruned only when EVERY query prunes it; if any query
    needs it, it is forwarded, so each query's master receives a superset
    of that query's survivors.
    """
    last_seq: int = -1

    def on_packet(self, seq: int, prune_fns) -> tuple[str, bool]:
        """Returns (action, processed). action: ack_prune|forward|drop.

        prune_fns: one decision callable a query. All are evaluated on
        first processing (every query's switch state updates), not
        short-circuited.
        """
        if seq == self.last_seq + 1:
            self.last_seq = seq
            pruned = [bool(fn(seq)) for fn in prune_fns]
            return ("ack_prune" if all(pruned) else "forward"), True
        if seq <= self.last_seq:
            return "forward", False
        return "drop", False


def _host(mask) -> np.ndarray:
    """A keep mask (numpy, a sequence, or a torch tensor on any device) as
    a numpy array, copied off the device once."""
    if isinstance(mask, torch.Tensor):
        return mask.cpu().numpy()
    return np.asarray(mask)


def combined_forward_mask(keep_batch) -> np.ndarray:
    """[Q, m] per-query keep masks -> the switch's single per-entry forward
    decision: forward iff any of the Q queries keeps it."""
    return np.any(_host(keep_batch), axis=0)


def simulate_lossy_stream_multi(values, keep_batch, drop_prob: float,
                                seed: int = 0,
                                max_rounds: int = 64) -> dict:
    """``simulate_lossy_stream`` for Q multiplexed queries.

    keep_batch: [Q, m] per-query keep masks (e.g.
    ``engine_prune_batch(...).keep``). The switch forwards an entry iff any
    query keeps it, so the master-received set is a superset of every
    query's survivor set.
    """
    return simulate_lossy_stream(values, combined_forward_mask(keep_batch),
                                 drop_prob, seed, max_rounds)


def simulate_lossy_stream(values, prune_keep_mask, drop_prob: float,
                          seed: int = 0, max_rounds: int = 64) -> dict:
    """Workers retransmit un-ACKed packets; the switch runs the §7.2
    protocol.

    ``prune_keep_mask[i]`` is the (deterministic) switch decision for entry
    i the first time it is processed. Packets and ACKs are dropped i.i.d.
    with ``drop_prob``. Returns master-received indices and stats. A round
    walks every unacknowledged packet, and every packet after the first
    gap is dropped, so a lossy run costs O(m^2 p) Python steps, as the
    reference's does.
    """
    keep = _host(prune_keep_mask)
    rng = np.random.default_rng(seed)
    m = len(values)
    sw = SwitchReliability()
    acked = [False] * m
    master_got: list[int] = []
    rounds = 0
    processed_decision = {}
    while not all(acked) and rounds < max_rounds:
        rounds += 1
        for seq in range(m):
            if acked[seq]:
                continue
            if rng.random() < drop_prob:      # worker -> switch loss
                continue
            action, processed = sw.on_packet(seq,
                                             lambda s: not bool(keep[s]))
            if processed:
                processed_decision[seq] = action
            if action == "ack_prune":
                if rng.random() >= drop_prob:  # switch -> worker ACK loss
                    acked[seq] = True
            elif action == "forward":
                if rng.random() < drop_prob:   # switch -> master loss
                    continue
                master_got.append(seq)
                if rng.random() >= drop_prob:  # master -> worker ACK loss
                    acked[seq] = True
            # drop: wait for the retransmission of the gap's head
    return {
        "master_indices": sorted(set(master_got)),
        "delivered_all": all(acked),
        "rounds": rounds,
        "double_processed": False,  # by construction: processed once a seq
        "decisions": processed_decision,
    }
