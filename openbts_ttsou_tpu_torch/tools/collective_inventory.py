"""The collective inventory of the sharded pipelines: what one step moves
between shards, by collective kind.

The port of `tools/collective_inventory.py`. The JAX tool walks XLA's
optimized HLO for collective ops; the port's mesh counts its own
collectives as it runs them (`parallel/mesh.py` `Mesh.traffic`: calls
and the bytes that land on one shard, the op's output, as the JAX tool
counts a device's). This runs one sharded uplink step and one sharded
duplex step (`parallel/dryrun.py` `sharded_steps`) over a mesh of
`--shards` shards (2 carriers a chan shard unless `--carriers` says
otherwise) and prints the JAX tool's layout: the mesh, the carriers, the
frames a step, per step kind {collective: {count, bytes_per_step}}, and
a shard's input bytes a step. The mesh's kinds are `permute` (XLA's
collective-permute), `all-reduce` and `all-gather`.

    python -m openbts_ttsou_tpu_torch.tools.collective_inventory \\
        [--shards 8] [--carriers N]
"""

from __future__ import annotations

from openbts_ttsou_tpu_torch.tools import common

TOOL = "collective_inventory"


def inventory(n_shards: int, device, carriers: int | None = None) -> dict:
    from openbts_ttsou_tpu_torch.parallel import dryrun

    s = dryrun.sharded_steps(n_shards, device, carriers)
    n_chan_dev = s.mesh.shape["chan"]
    return {"mesh": dict(s.mesh.shape), "n_chan_total": s.cfg.n_chan,
            "frames_per_step": s.mesh.shape["time"] * s.spec.frames_per_shard,
            "uplink": s.traffic_up, "duplex": s.traffic_dup,
            "local_input_bytes_per_step":
                s.spec.block_in * 8 * (s.cfg.n_chan // n_chan_dev)}


def main(argv=None) -> dict:
    ap = common.parser(__doc__)
    ap.add_argument("--shards", type=int, default=8)
    ap.add_argument("--carriers", type=int, default=None,
                    help="carriers in all (default: 2 a chan shard)")
    args = ap.parse_args(argv)
    dev = common.device_of(args)
    return common.emit({"tool": TOOL,
                        **inventory(args.shards, dev, args.carriers),
                        **common.card(dev)})


if __name__ == "__main__":
    main()
