"""Host-side metric meters (python scalars)."""


class AccMeter:
    """Top-1 / top-k correct-count accumulator."""

    def __init__(self):
        self.reset()

    def reset(self):
        self.correct_num = 0
        self.topk_correct_num = 0
        self.sample_num = 0

    def update(self, correct, topk_correct, n):
        self.correct_num += int(correct)
        self.topk_correct_num += int(topk_correct)
        self.sample_num += int(n)

    @property
    def acc1(self):
        return self.correct_num / max(self.sample_num, 1) * 100.0

    @property
    def acc_topk(self):
        return self.topk_correct_num / max(self.sample_num, 1) * 100.0
