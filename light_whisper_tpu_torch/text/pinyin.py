"""Han character → pinyin (toneless) lookup for hot-word matching.

The port's copy of ``light_whisper_tpu/text/pinyin.py``.

The reference uses the Rust ``pinyin`` crate's default reading per character
(``qwen_hotword_service.rs:472-477``). The correction algorithm only tests
*signature equality* between a hot word and a candidate span, so what matters
is that homophones map to the same string; characters absent from the table
make the span ineligible (a conservative miss, never a false replacement).

Coverage: a generated table of 18.7k characters (``pinyin_data.py``,
recovered from CLDR pinyin-collation groups — see
``scripts/gen_pinyin_table.py``) underlies a hand-curated built-in table of
dominant readings (which wins on polyphones); a user-supplied table via
``LIGHT_WHISPER_PINYIN_TABLE`` (a JSON object of ``{"字": "zi"}``) merges
over both.
"""

from __future__ import annotations

import functools
import json
import os
from typing import Dict, List, Optional, Sequence

# Most-common reading per character, toneless. Multi-reading characters use
# their dominant reading (mirroring the Rust crate's default).
_BUILTIN = {
    # top function/common words
    "的": "de", "一": "yi", "是": "shi", "不": "bu", "了": "le", "在": "zai",
    "人": "ren", "有": "you", "我": "wo", "他": "ta", "这": "zhe", "个": "ge",
    "们": "men", "中": "zhong", "来": "lai", "上": "shang", "大": "da",
    "为": "wei", "和": "he", "国": "guo", "地": "di", "到": "dao", "以": "yi",
    "说": "shuo", "时": "shi", "要": "yao", "就": "jiu", "出": "chu", "会": "hui",
    "可": "ke", "也": "ye", "你": "ni", "对": "dui", "生": "sheng", "能": "neng",
    "而": "er", "子": "zi", "那": "na", "得": "de", "于": "yu", "着": "zhe",
    "下": "xia", "自": "zi", "之": "zhi", "年": "nian", "过": "guo", "发": "fa",
    "后": "hou", "作": "zuo", "里": "li", "用": "yong", "道": "dao", "行": "xing",
    "所": "suo", "然": "ran", "家": "jia", "种": "zhong", "事": "shi", "成": "cheng",
    "方": "fang", "多": "duo", "经": "jing", "么": "me", "去": "qu", "法": "fa",
    "学": "xue", "如": "ru", "都": "dou", "同": "tong", "现": "xian", "当": "dang",
    "没": "mei", "动": "dong", "面": "mian", "起": "qi", "看": "kan", "定": "ding",
    "天": "tian", "分": "fen", "还": "hai", "进": "jin", "好": "hao", "小": "xiao",
    "部": "bu", "其": "qi", "些": "xie", "主": "zhu", "样": "yang", "理": "li",
    "心": "xin", "她": "ta", "本": "ben", "前": "qian", "开": "kai", "但": "dan",
    "因": "yin", "只": "zhi", "从": "cong", "想": "xiang", "实": "shi", "日": "ri",
    "军": "jun", "者": "zhe", "意": "yi", "无": "wu", "力": "li", "它": "ta",
    "与": "yu", "长": "chang", "把": "ba", "机": "ji", "十": "shi", "民": "min",
    "第": "di", "公": "gong", "此": "ci", "已": "yi", "工": "gong", "使": "shi",
    "情": "qing", "明": "ming", "性": "xing", "知": "zhi", "全": "quan", "三": "san",
    "又": "you", "关": "guan", "点": "dian", "正": "zheng", "业": "ye", "外": "wai",
    "两": "liang", "高": "gao", "间": "jian", "由": "you", "问": "wen", "很": "hen",
    "最": "zui", "重": "zhong", "并": "bing", "物": "wu", "手": "shou", "应": "ying",
    "战": "zhan", "向": "xiang", "头": "tou", "文": "wen", "体": "ti", "政": "zheng",
    "美": "mei", "相": "xiang", "见": "jian", "被": "bei", "利": "li", "什": "shen",
    "二": "er", "等": "deng", "产": "chan", "或": "huo", "新": "xin", "己": "ji",
    "制": "zhi", "身": "shen", "果": "guo", "加": "jia", "西": "xi", "斯": "si",
    "月": "yue", "话": "hua", "合": "he", "回": "hui", "特": "te", "代": "dai",
    "内": "nei", "信": "xin", "表": "biao", "化": "hua", "老": "lao", "给": "gei",
    "世": "shi", "位": "wei", "次": "ci", "度": "du", "门": "men", "任": "ren",
    "常": "chang", "先": "xian", "海": "hai", "通": "tong", "教": "jiao", "儿": "er",
    "原": "yuan", "东": "dong", "声": "sheng", "提": "ti", "立": "li", "及": "ji",
    "比": "bi", "员": "yuan", "解": "jie", "水": "shui", "名": "ming", "真": "zhen",
    "论": "lun", "处": "chu", "走": "zou", "义": "yi", "各": "ge", "入": "ru",
    "几": "ji", "口": "kou", "认": "ren", "条": "tiao", "平": "ping", "系": "xi",
    "气": "qi", "题": "ti", "活": "huo", "尔": "er", "更": "geng", "别": "bie",
    "打": "da", "女": "nv", "变": "bian", "四": "si", "神": "shen", "总": "zong",
    "何": "he", "电": "dian", "数": "shu", "安": "an", "少": "shao", "报": "bao",
    "才": "cai", "结": "jie", "反": "fan", "受": "shou", "目": "mu", "太": "tai",
    "量": "liang", "再": "zai", "感": "gan", "建": "jian", "务": "wu", "做": "zuo",
    "接": "jie", "必": "bi", "场": "chang", "件": "jian", "计": "ji", "管": "guan",
    "期": "qi", "市": "shi", "直": "zhi", "德": "de", "资": "zi", "命": "ming",
    "山": "shan", "金": "jin", "指": "zhi", "克": "ke", "许": "xu", "统": "tong",
    "区": "qu", "保": "bao", "至": "zhi", "队": "dui", "形": "xing", "社": "she",
    "便": "bian", "空": "kong", "决": "jue", "治": "zhi", "展": "zhan", "马": "ma",
    "科": "ke", "司": "si", "五": "wu", "基": "ji", "眼": "yan", "书": "shu",
    "非": "fei", "则": "ze", "听": "ting", "白": "bai", "却": "que", "界": "jie",
    "达": "da", "光": "guang", "放": "fang", "强": "qiang", "即": "ji", "像": "xiang",
    "难": "nan", "且": "qie", "权": "quan", "思": "si", "王": "wang", "象": "xiang",
    "完": "wan", "设": "she", "式": "shi", "色": "se", "路": "lu", "记": "ji",
    "南": "nan", "品": "pin", "住": "zhu", "告": "gao", "类": "lei", "求": "qiu",
    "据": "ju", "程": "cheng", "北": "bei", "边": "bian", "死": "si", "张": "zhang",
    "该": "gai", "交": "jiao", "规": "gui", "万": "wan", "取": "qu", "拉": "la",
    "格": "ge", "望": "wang", "觉": "jue", "术": "shu", "领": "ling", "共": "gong",
    "确": "que", "传": "chuan", "师": "shi", "观": "guan", "清": "qing", "今": "jin",
    "切": "qie", "院": "yuan", "让": "rang", "识": "shi", "候": "hou", "带": "dai",
    "导": "dao", "争": "zheng", "运": "yun", "笑": "xiao", "飞": "fei", "风": "feng",
    "步": "bu", "改": "gai", "收": "shou", "根": "gen", "干": "gan", "造": "zao",
    "言": "yan", "联": "lian", "持": "chi", "组": "zu", "每": "mei", "济": "ji",
    "车": "che", "亲": "qin", "极": "ji", "林": "lin", "服": "fu", "快": "kuai",
    "办": "ban", "议": "yi", "往": "wang", "元": "yuan", "英": "ying", "士": "shi",
    "证": "zheng", "近": "jin", "失": "shi", "转": "zhuan", "夫": "fu", "令": "ling",
    "准": "zhun", "布": "bu", "始": "shi", "怎": "zen", "呢": "ne", "存": "cun",
    "未": "wei", "远": "yuan", "叫": "jiao", "台": "tai", "单": "dan", "影": "ying",
    "具": "ju", "罗": "luo", "字": "zi", "爱": "ai", "击": "ji", "流": "liu",
    "备": "bei", "兵": "bing", "连": "lian", "调": "diao", "深": "shen", "商": "shang",
    "算": "suan", "质": "zhi", "团": "tuan", "集": "ji", "百": "bai", "需": "xu",
    "价": "jia", "花": "hua", "党": "dang", "华": "hua", "城": "cheng", "石": "shi",
    "级": "ji", "整": "zheng", "府": "fu", "离": "li", "况": "kuang", "亚": "ya",
    "请": "qing", "技": "ji", "际": "ji", "约": "yue", "示": "shi", "复": "fu",
    "病": "bing", "息": "xi", "究": "jiu", "线": "xian", "似": "si", "官": "guan",
    "火": "huo", "断": "duan", "精": "jing", "满": "man", "支": "zhi", "视": "shi",
    "消": "xiao", "越": "yue", "器": "qi", "容": "rong", "照": "zhao", "须": "xu",
    "九": "jiu", "增": "zeng", "研": "yan", "写": "xie", "称": "cheng", "企": "qi",
    "八": "ba", "功": "gong", "吗": "ma", "包": "bao", "片": "pian", "史": "shi",
    "委": "wei", "乎": "hu", "查": "cha", "轻": "qing", "易": "yi", "早": "zao",
    "曾": "ceng", "除": "chu", "农": "nong", "找": "zhao", "装": "zhuang",
    "广": "guang", "显": "xian", "吧": "ba", "阿": "a", "李": "li", "标": "biao",
    "谈": "tan", "吃": "chi", "图": "tu", "念": "nian", "六": "liu", "引": "yin",
    "历": "li", "首": "shou", "医": "yi", "局": "ju", "突": "tu", "专": "zhuan",
    "费": "fei", "号": "hao", "尽": "jin", "另": "ling", "周": "zhou", "较": "jiao",
    "注": "zhu", "语": "yu", "仅": "jin", "考": "kao", "落": "luo", "青": "qing",
    "随": "sui", "选": "xuan", "列": "lie", "武": "wu", "红": "hong", "响": "xiang",
    "虽": "sui", "推": "tui", "势": "shi", "参": "can", "希": "xi", "古": "gu",
    "众": "zhong", "构": "gou", "房": "fang", "半": "ban", "节": "jie", "土": "tu",
    "投": "tou", "某": "mou", "案": "an", "黑": "hei", "维": "wei", "革": "ge",
    "划": "hua", "敌": "di", "致": "zhi", "陈": "chen", "律": "lv", "足": "zu",
    "态": "tai", "护": "hu", "七": "qi", "兴": "xing", "派": "pai", "孩": "hai",
    "验": "yan", "责": "ze", "营": "ying", "星": "xing", "够": "gou", "章": "zhang",
    "音": "yin", "跟": "gen", "志": "zhi", "底": "di", "站": "zhan", "严": "yan",
    "巴": "ba", "例": "li", "防": "fang", "族": "zu", "供": "gong", "效": "xiao",
    "续": "xu", "施": "shi", "留": "liu", "讲": "jiang", "型": "xing", "料": "liao",
    "终": "zhong", "答": "da", "紧": "jin", "黄": "huang", "绝": "jue", "奇": "qi",
    "察": "cha", "母": "mu", "京": "jing", "段": "duan", "依": "yi", "批": "pi",
    "群": "qun", "项": "xiang", "故": "gu", "按": "an", "河": "he", "米": "mi",
    "围": "wei", "江": "jiang", "织": "zhi", "害": "hai", "斗": "dou", "双": "shuang",
    "境": "jing", "客": "ke", "纪": "ji", "采": "cai", "举": "ju", "杀": "sha",
    "攻": "gong", "父": "fu", "苏": "su", "密": "mi", "低": "di", "朝": "chao",
    "友": "you", "诉": "su", "止": "zhi", "细": "xi", "愿": "yuan", "千": "qian",
    "值": "zhi", "仍": "reng", "男": "nan", "钱": "qian", "破": "po", "网": "wang",
    "热": "re", "助": "zhu", "倒": "dao", "育": "yu", "属": "shu", "坐": "zuo",
    "帝": "di", "限": "xian", "船": "chuan", "脸": "lian", "职": "zhi", "速": "su",
    "刻": "ke", "乐": "le", "否": "fou", "刚": "gang", "威": "wei", "毛": "mao",
    "状": "zhuang", "率": "lv", "甚": "shen", "独": "du", "球": "qiu", "般": "ban",
    "普": "pu", "怕": "pa", "弹": "dan", "校": "xiao", "苦": "ku", "创": "chuang",
    "假": "jia", "久": "jiu", "错": "cuo", "承": "cheng", "印": "yin", "晚": "wan",
    "兰": "lan", "试": "shi", "股": "gu", "拿": "na", "脑": "nao", "预": "yu",
    "谁": "shei", "益": "yi", "阳": "yang", "若": "ruo", "哪": "na", "微": "wei",
    "尼": "ni", "继": "ji", "送": "song", "急": "ji", "血": "xue", "惊": "jing",
    "伤": "shang", "素": "su", "药": "yao", "适": "shi", "波": "bo", "夜": "ye",
    "省": "sheng", "初": "chu", "喜": "xi", "卫": "wei", "源": "yuan", "食": "shi",
    "险": "xian", "待": "dai", "述": "shu", "陆": "lu", "习": "xi", "置": "zhi",
    "居": "ju", "财": "cai", "环": "huan", "排": "pai", "福": "fu", "纳": "na",
    "欢": "huan", "雷": "lei", "警": "jing", "获": "huo", "模": "mo", "充": "chong",
    "负": "fu", "云": "yun", "停": "ting", "木": "mu", "游": "you", "龙": "long",
    "树": "shu", "疑": "yi", "层": "ceng", "冷": "leng", "洲": "zhou", "冲": "chong",
    "射": "she", "略": "lve", "范": "fan", "竟": "jing", "句": "ju", "室": "shi",
    "异": "yi", "激": "ji", "汉": "han", "村": "cun", "哈": "ha", "策": "ce",
    "演": "yan", "简": "jian", "卡": "ka", "罪": "zui", "判": "pan", "担": "dan",
    "州": "zhou", "静": "jing", "退": "tui", "墨": "mo", "曲": "qu", "辑": "ji",
    "乱": "luan", "触": "chu", "兼": "jian", "亿": "yi", "脚": "jiao", "争": "zheng",
    # tech / dictation vocabulary
    "智": "zhi", "块": "kuai", "链": "lian", "码": "ma", "库": "ku", "框": "kuang",
    "架": "jia", "序": "xu", "函": "han", "端": "duan", "口": "kou", "载": "zai",
    "储": "chu", "存": "cun", "训": "xun", "练": "lian", "测": "ce", "编": "bian",
    "译": "yi", "接": "jie", "配": "pei", "署": "shu", "版": "ban", "录": "lu",
    "音": "yin", "频": "pin", "像": "xiang", "缓": "huan", "优": "you", "迭": "die",
    "态": "tai", "令": "ling", "牌": "pai", "启": "qi", "错": "cuo", "误": "wu",
    "调": "diao", "试": "shi", "窗": "chuang", "键": "jian", "盘": "pan", "鼠": "shu",
    # dominant readings that differ from the CLDR collation reading (the
    # generated table groups these by their collation reading; this overlay
    # wins — see scripts/gen_pinyin_table.py ANCHOR_EXCLUDE)
    "佛": "fo", "咳": "ke",
}


@functools.lru_cache(maxsize=1)
def pinyin_table() -> Dict[str, str]:
    # Broad generated table first (18k+ chars recovered from CLDR pinyin
    # collation — see scripts/gen_pinyin_table.py), then the hand-curated
    # dominant readings on top (wins on polyphones like 佛/咳), then any
    # user-supplied table.
    table: Dict[str, str] = {}
    try:
        from light_whisper_tpu_torch.text.pinyin_data import SYLLABLE_CHARS

        for syllable, chars in SYLLABLE_CHARS.items():
            for ch in chars:
                table[ch] = syllable
    except ImportError:  # generated data stripped from a minimal install
        pass
    table.update(_BUILTIN)
    extra_path = os.environ.get("LIGHT_WHISPER_PINYIN_TABLE")
    if extra_path and os.path.isfile(extra_path):
        try:
            with open(extra_path, "r", encoding="utf-8") as f:
                table.update(json.load(f))
        except (OSError, json.JSONDecodeError):
            pass
    return table


def pinyin_signature(chars: Sequence[str]) -> Optional[List[str]]:
    """Per-char toneless readings; None if any char is unknown."""
    out: List[str] = []
    table = pinyin_table()
    for ch in chars:
        reading = table.get(ch)
        if reading is None:
            return None
        out.append(reading)
    return out
