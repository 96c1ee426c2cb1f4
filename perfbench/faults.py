"""Faults planted under a run's timed path, for the tests and for
``perfbench.calibrate``: each is a context manager that patches one of
the program's classes and puts it back.

- ``unchanged``: a step returns its state unchanged (training: the
  update is skipped; serving: the LSTM carry is not advanced).
- ``half_batch``: half of the batch left out (training: the second half
  of the valid rows marked not valid, so the mean is taken over the rest;
  serving: the second half of the rows' windows zeroed).
- ``token``: a token altered where it is produced (serving: the decoder
  bumps each row's last emitted id).
"""

import contextlib

__all__ = ['FAULTS', 'planted']

FAULTS = {'train': ('unchanged', 'half_batch'),
          'serve': ('unchanged', 'half_batch', 'token')}


@contextlib.contextmanager
def _patched(cls, name, make):
    original = getattr(cls, name)
    setattr(cls, name, make(original))
    try:
        yield
    finally:
        setattr(cls, name, original)


def planted(kind, fault):
    """The context manager that plants ``fault`` under a ``kind`` run."""
    if kind == 'train':
        from nbasr_torch.training import Trainer
        if fault == 'unchanged':
            return _patched(Trainer, '_update',
                            lambda f: lambda self, lr: None)

        def half(f):
            def put(self, batch):
                out = f(self, batch)
                rows = out['valid'].nonzero().flatten()
                out['valid'][rows[len(rows) // 2:]] = 0
                return out
            return put
        return _patched(Trainer, '_put_batch', half)
    from nbasr_torch.serving import StreamingASR, StreamingGreedyDecoder
    if fault == 'unchanged':
        def frozen(f):
            def step(self, window, mask, trim, carry):
                logits, _ = f(self, window, mask, trim, carry)
                return logits, carry
            return step
        return _patched(StreamingASR, '_device_step', frozen)
    if fault == 'half_batch':
        def half(f):
            def step(self, window, mask, trim, carry):
                window = window.clone()
                window[window.shape[0] // 2:] = 0
                return f(self, window, mask, trim, carry)
            return step
        return _patched(StreamingASR, '_device_step', half)

    def bump(f):
        def push(self, logits, valid_len):
            tokens = f(self, logits, valid_len)
            for row in tokens:
                if row:
                    row[-1] = row[-1] % 48 + 1
            return tokens
        return push
    return _patched(StreamingGreedyDecoder, 'push', bump)
