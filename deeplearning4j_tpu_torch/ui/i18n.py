"""Training-UI internationalization — DefaultI18N parity.

Reference: deeplearning4j-ui-parent/deeplearning4j-play/src/main/java/org/
deeplearning4j/ui/i18n/DefaultI18N.java — per-language key->message maps
loaded from "somekey.langcode" resource files, with fallback to English
for keys a language lacks, a process-wide instance, and
setDefaultLanguage().

Here the common train-UI messages ship embedded for the languages the
reference localizes most fully (en, ja, zh, ko, de, fr, ru); additional
languages or keys load from resource files in the reference's own format
(``load_directory``: files named ``<anything>.<langcode>`` holding
``key=value`` lines, '#' comments). Unknown key -> the key itself,
unknown language -> English — both DefaultI18N behaviors.
"""

from __future__ import annotations

import os
from typing import Dict, Optional

DEFAULT_LANGUAGE = "en"
FALLBACK_LANGUAGE = "en"

_MESSAGES: Dict[str, Dict[str, str]] = {
    "en": {
        "train.system": "System",
        "train.pagetitle": "deeplearning4j_tpu training UI",
        "train.overview.title": "Training overview",
        "train.session": "Session",
        "train.overview.chart.score": "Score vs iteration",
        "train.overview.chart.throughput": "Throughput (samples/sec)",
        "train.model.chart.l2norm": "Parameter L2 norms",
        "train.model.chart.updateratio": "Update/parameter ratio (learning-rate health)",
        "train.model.histograms": "Weight histograms (latest iteration)",
        "tsne.title": "t-SNE embeddings",
        "tsne.points": "points",
        "tsne.empty": ("No embeddings uploaded — POST JSON "
                       "{\"coords\": [[x,y]...], \"labels\": [...]} to "
                       "/tsne, or call UIServer.upload_tsne()."),
    },
    "ja": {
        "train.system": "システム",
        "train.pagetitle": "deeplearning4j_tpu トレーニングUI",
        "train.overview.title": "トレーニング概要",
        "train.session": "セッション",
        "train.overview.chart.score": "スコア対反復回数",
        "train.overview.chart.throughput": "スループット (サンプル/秒)",
        "train.model.chart.l2norm": "パラメータL2ノルム",
        "train.model.chart.updateratio": "更新/パラメータ比率 (学習率の健全性)",
        "train.model.histograms": "重みヒストグラム (最新の反復)",
        "tsne.title": "t-SNE埋め込み",
        "tsne.points": "点",
    },
    "zh": {
        "train.system": "系统",
        "train.pagetitle": "deeplearning4j_tpu 训练界面",
        "train.overview.title": "训练概览",
        "train.session": "会话",
        "train.overview.chart.score": "得分与迭代次数",
        "train.overview.chart.throughput": "吞吐量 (样本/秒)",
        "train.model.chart.l2norm": "参数L2范数",
        "train.model.chart.updateratio": "更新/参数比率 (学习率健康度)",
        "train.model.histograms": "权重直方图 (最新迭代)",
        "tsne.title": "t-SNE嵌入",
        "tsne.points": "个点",
    },
    "ko": {
        "train.system": "시스템",
        "train.pagetitle": "deeplearning4j_tpu 훈련 UI",
        "train.overview.title": "훈련 개요",
        "train.session": "세션",
        "train.overview.chart.score": "점수 대 반복",
        "train.overview.chart.throughput": "처리량 (샘플/초)",
        "train.model.chart.l2norm": "파라미터 L2 노름",
        "train.model.chart.updateratio": "업데이트/파라미터 비율 (학습률 상태)",
        "train.model.histograms": "가중치 히스토그램 (최근 반복)",
        "tsne.title": "t-SNE 임베딩",
        "tsne.points": "포인트",
    },
    "de": {
        "train.system": "System",
        "train.pagetitle": "deeplearning4j_tpu Trainings-UI",
        "train.overview.title": "Trainingsübersicht",
        "train.session": "Sitzung",
        "train.overview.chart.score": "Score über Iterationen",
        "train.overview.chart.throughput": "Durchsatz (Beispiele/Sek.)",
        "train.model.chart.l2norm": "Parameter-L2-Normen",
        "train.model.chart.updateratio": "Update/Parameter-Verhältnis (Lernraten-Gesundheit)",
        "train.model.histograms": "Gewichtshistogramme (letzte Iteration)",
        "tsne.title": "t-SNE-Einbettungen",
        "tsne.points": "Punkte",
    },
    "fr": {
        "train.system": "Système",
        "train.pagetitle": "Interface d'entraînement deeplearning4j_tpu",
        "train.overview.title": "Vue d'ensemble de l'entraînement",
        "train.session": "Session",
        "train.overview.chart.score": "Score par itération",
        "train.overview.chart.throughput": "Débit (échantillons/s)",
        "train.model.chart.l2norm": "Normes L2 des paramètres",
        "train.model.chart.updateratio": "Ratio mise à jour/paramètre (santé du taux d'apprentissage)",
        "train.model.histograms": "Histogrammes des poids (dernière itération)",
        "tsne.title": "Plongements t-SNE",
        "tsne.points": "points",
    },
    "ru": {
        "train.system": "Система",
        "train.pagetitle": "deeplearning4j_tpu — интерфейс обучения",
        "train.overview.title": "Обзор обучения",
        "train.session": "Сессия",
        "train.overview.chart.score": "Оценка по итерациям",
        "train.overview.chart.throughput": "Пропускная способность (образцов/с)",
        "train.model.chart.l2norm": "L2-нормы параметров",
        "train.model.chart.updateratio": "Отношение обновление/параметр (здоровье шага обучения)",
        "train.model.histograms": "Гистограммы весов (последняя итерация)",
        "tsne.title": "t-SNE-вложения",
        "tsne.points": "точек",
    },
}


class I18N:
    """Per-process message provider (DefaultI18N.getInstance surface)."""

    _instance: Optional["I18N"] = None

    def __init__(self):
        self._messages: Dict[str, Dict[str, str]] = {
            lang: dict(tbl) for lang, tbl in _MESSAGES.items()
        }
        self._default = DEFAULT_LANGUAGE

    @classmethod
    def get_instance(cls) -> "I18N":
        if cls._instance is None:
            cls._instance = cls()
        return cls._instance

    # -- DefaultI18N surface ----------------------------------------------
    def get_message(self, key: str, lang: Optional[str] = None) -> str:
        """Message for ``key`` in ``lang`` (default language when None),
        falling back to English, then to the key itself."""
        lang = (lang or self._default).lower()
        for table in (self._messages.get(lang),
                      self._messages.get(FALLBACK_LANGUAGE)):
            if table and key in table:
                return table[key]
        return key

    def get_default_language(self) -> str:
        return self._default

    def set_default_language(self, lang: str) -> "I18N":
        self._default = lang.lower()
        return self

    def languages(self):
        return sorted(self._messages)

    # -- resource files (the reference's "somekey.langcode" format) -------
    def load_file(self, path: str) -> "I18N":
        """One resource file named ``<anything>.<langcode>`` holding
        ``key=value`` lines ('#'/'!' comments, blank lines ignored)."""
        name = os.path.basename(path)
        lang = name.rsplit(".", 1)[-1].lower() if "." in name else ""
        if not (2 <= len(lang) <= 3 and lang.isalpha()):
            raise ValueError(
                f"resource file {name!r} needs a language-code extension "
                "(e.g. messages.en)")
        table = self._messages.setdefault(lang, {})
        with open(path, encoding="utf-8") as f:
            for line in f:
                line = line.strip()
                if not line or line[0] in "#!" or "=" not in line:
                    continue
                k, v = line.split("=", 1)
                table[k.strip()] = v.strip()
        return self

    def load_directory(self, path: str) -> "I18N":
        """Load every resource file of a dl4j_i18n-style directory. Only
        files whose extension LOOKS like a language code (2-3 lowercase
        letters) register — a stray README.md would otherwise pollute
        languages() with a bogus 'md' pack."""
        for name in sorted(os.listdir(path)):
            full = os.path.join(path, name)
            ext = name.rsplit(".", 1)[-1] if "." in name else ""
            if os.path.isfile(full) and 2 <= len(ext) <= 3 \
                    and ext.isalpha() and ext.islower():
                self.load_file(full)
        return self
