"""`python -m openbts_ttsou_tpu_torch.smqueue`: the store-and-forward
SMS daemon over UDP (see `queue.main` for its arguments)."""

from openbts_ttsou_tpu_torch.smqueue.queue import main

if __name__ == "__main__":
    main()
